"""Device-side compute: geometry, surfaces, the trace, the fused kernels."""
