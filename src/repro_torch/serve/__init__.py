from repro_torch.serve.engine import (ContinuousBatcher, DisaggregatedBatcher,
                                      ServeRequest, check_serve_supported,
                                      greedy_decode, local_serve_params,
                                      prefill, prompt_batch, serve_parallel,
                                      serve_step)

__all__ = ["ContinuousBatcher", "DisaggregatedBatcher", "ServeRequest",
           "check_serve_supported", "greedy_decode", "local_serve_params",
           "prefill", "prompt_batch", "serve_parallel", "serve_step"]
