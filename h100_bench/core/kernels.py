"""The profiler names of the port's kernels that the roofline metrics read,
by kernel (the csrc/ entry points; a needle matches a name that holds it)."""
KERNEL_NAMES = {
    "flash_attention": ("flash_fwd_wgmma", "flash_fwd_simt"),
    "conv3d_k3": ("conv3d_k3_wgmma",),
    "spatial_stats_3d": ("stats_kernel",),
    "corner_lerp": ("lerp_vector", "lerp_scalar"),
    "ray_expand": ("ray_expand_kernel",),
    "fused_resnetfc_int8": ("resnetfc_wgmma<false", "resnetfc_kernel<false"),
}
