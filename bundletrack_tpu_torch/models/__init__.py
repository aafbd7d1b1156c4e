"""Networks other than the keypoint frontend: VOS mask propagation."""
