"""Multi-device tracing over torch.distributed (≙ tinybvh_tpu/parallel)."""
