"""Port of corbslam_tpu/optim."""
