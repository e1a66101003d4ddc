"""Port of corbslam_tpu/mapstate."""
