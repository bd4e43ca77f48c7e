"""Models of the ported system: the TDS acoustic model (`tds`) and the
LM stack (`layers`, `mamba`, `moe`, `transformer`): dense, MoE, SSM and
hybrid families."""
from repro_torch.models.transformer import LM, pad_vocab, params_from_numpy

__all__ = ["LM", "pad_vocab", "params_from_numpy"]
