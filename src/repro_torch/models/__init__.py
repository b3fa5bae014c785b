from repro_torch.models.transformer import (active_param_count,
                                            cache_from_prefill, cross_entropy,
                                            decode_step, forward, init_cache,
                                            init_params, param_count,
                                            param_shapes)

__all__ = ["active_param_count", "cache_from_prefill", "cross_entropy",
           "decode_step", "forward", "init_cache", "init_params",
           "param_count", "param_shapes"]
