from repro_torch.serve.engine import (ContinuousBatcher, DisaggregatedBatcher,
                                      ServeRequest, greedy_decode, prefill,
                                      serve_step)

__all__ = ["ContinuousBatcher", "DisaggregatedBatcher", "ServeRequest",
           "greedy_decode", "prefill", "serve_step"]
