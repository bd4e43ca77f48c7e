"""The sharded LM cells on the card: tiny `build_cell` prefill and
decode cells on a 1x2 ('data', 'model') mesh of 2 ranks sharing the one
card (gloo), the kernel path (rmsnorm and flash kernels on each rank's
tensors) against the plain path on the same rank blocks of one seeded
init.  Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm_mesh.py

Tolerances: fp32 prefill logits within 1e-4 (`chip_smoke.py`'s
LM_LOGIT_RTOL: the kernels sum in another order than the plain
versions), decode tokens equal; bf16 logits within 2e-2 of max |logit|
(flash rounds P to bf16).  Launches per rank and cell: rmsnorm two a
layer and the final one, flash one an attention layer in prefill, none
in decode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402

pytestmark = pytest.mark.cuda
CASES = [("h2o fp32", "h2o-danube-1.8b", "1x2", "float32"),
         ("h2o bf16", "h2o-danube-1.8b", "1x2", "bfloat16"),
         ("qwen2-moe fp32", "qwen2-moe-a2.7b", "1x2", "float32"),
         ("mamba2 fp32", "mamba2-1.3b", "1x2", "float32")]


@pytest.fixture(scope="module")
def on_card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return ranks.run(2, tmp_path_factory.mktemp("lm_kernels"), "lm_kernels",
                     {"cases": CASES, "batch": 2, "seq": 128}, device="cuda")


@pytest.mark.parametrize("name,arch,mesh,dtype", CASES)
def test_sharded_cell_kernel_path_matches_plain(name, arch, mesh, dtype,
                                                on_card):
    cfg = get_config(arch).tiny()
    n_attn = sum(cfg.layer_kind(i % cfg.period) == "attn"
                 for i in range(cfg.n_layers))
    for rank in on_card:
        r = rank[name]
        k, p = r["kernel"]["logits"], r["plain"]["logits"]
        if dtype == "float32":
            np.testing.assert_allclose(k, p, rtol=0, atol=1e-4)
            np.testing.assert_array_equal(r["kernel"]["tok"],
                                          r["plain"]["tok"])
        else:
            assert np.abs(k - p).max() <= 2e-2 * np.abs(p).max()
        norms = 2 * cfg.n_layers + 1
        assert r["kernel"]["prefill_launches"]["rmsnorm"] == norms
        assert r["kernel"]["prefill_launches"]["flash_attention"] == n_attn
        assert r["kernel"]["decode_launches"]["rmsnorm"] == norms
        assert r["kernel"]["decode_launches"]["flash_attention"] == 0
        assert r["plain"]["prefill_launches"]["rmsnorm"] == 0
