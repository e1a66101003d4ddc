"""Port of corbslam_tpu/matching."""
