"""KITTI dataset I/O."""
