from repro_torch.models.transformer import (cache_from_prefill, cross_entropy,
                                            decode_step, forward, init_cache,
                                            init_params, param_count,
                                            param_shapes)

__all__ = ["cache_from_prefill", "cross_entropy", "decode_step", "forward",
           "init_cache", "init_params", "param_count", "param_shapes"]
