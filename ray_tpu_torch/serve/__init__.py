"""ray_tpu_torch.serve — online model serving.

Only the inference engine is ported so far; the serve runtime (controller,
router, HTTP ingress, resilience) comes in a later slice.
"""
