from repro_torch.data.pipeline import SyntheticTokens

__all__ = ["SyntheticTokens"]
