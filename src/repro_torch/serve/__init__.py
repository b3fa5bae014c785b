from repro_torch.serve.engine import (ContinuousBatcher, DisaggregatedBatcher,
                                      ServeRequest, greedy_decode, prefill,
                                      prompt_batch, serve_step)

__all__ = ["ContinuousBatcher", "DisaggregatedBatcher", "ServeRequest",
           "greedy_decode", "prefill", "prompt_batch", "serve_step"]
