"""The stereo odometry pipeline."""
