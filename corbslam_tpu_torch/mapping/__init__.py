"""Port of corbslam_tpu/mapping."""
