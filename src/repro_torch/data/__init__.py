from repro_torch.data.pipeline import SyntheticTokens, batch_for

__all__ = ["SyntheticTokens", "batch_for"]
