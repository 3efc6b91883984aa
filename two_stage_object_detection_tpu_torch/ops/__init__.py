"""Box ops, anchors, NMS, RoIAlign and the wrappers of the CUDA kernels."""
