"""Models of the ported system: the TDS acoustic model (`tds`) and the
dense LM stack (`layers`, `transformer`)."""
from repro_torch.models.transformer import LM, pad_vocab, params_from_numpy

__all__ = ["LM", "pad_vocab", "params_from_numpy"]
