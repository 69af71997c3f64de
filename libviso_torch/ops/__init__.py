"""Device ops: detector, descriptors, matcher, circle filter."""
