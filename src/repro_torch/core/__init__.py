"""Core ReaLB layers of the port: NVFP4 recipe, policy, MoE layer."""
