"""The engines' steps under their host-sync guard, on the card.

Each test needs a CUDA device and skips without one (decided in the
`cuda` fixture, never at import).  On the card the guard is the sync
debug mode in error: a warmed step that makes the host wait (a scalar
readback, an op sized by its data, a blocking upload) raises.  Pins the
per-slot cache write of `LM.decode_step` (`models/transformer.py`), whose
advanced index by an int32 slot waited on the host every decode step
until it became a scatter, and holds an ASR and an LM worker of one
server to the guard at once.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_guards.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import guards  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the guard is the card's sync "
                    "debug mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def test_guard_raises_on_a_readback_and_a_pageable_upload(cuda):
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError, match="synchronizing"):
        with guards.no_implicit_transfers():
            x.sum().item()
    with pytest.raises(RuntimeError, match="synchronizing"):
        with guards.no_implicit_transfers():
            torch.from_numpy(np.zeros(8, np.float32)).to(cuda)
    with guards.no_implicit_transfers():
        with guards.allow_transfers():
            assert x.sum().item() == 4.0
    assert guards._owners == {}


@pytest.mark.parametrize("use_int8", [False, True])
def test_warmed_asr_steps_run_under_the_guard(cuda, use_int8):
    from repro_torch.launch.serve import asr_demo_engine
    eng, _ = asr_demo_engine(4, device=cuda, use_int8=use_int8)
    rng = np.random.default_rng(0)
    for s in range(4):
        eng.feed_slot(s, rng.standard_normal(
            eng.plan.samples_per_step * 9 + 400).astype(np.float32) * 0.1)
    assert eng._step()                          # warm-up
    with guards.compilation_budget(0, "warmed ASR step"):
        assert eng._step()
        torch.cuda.synchronize()


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "qwen2-moe-a2.7b"])
def test_warmed_lm_decode_steps_run_under_the_guard(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serving import EngineConfig, LmEngine, LmProgram
    cfg = get_config(arch).tiny()
    params = LM(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    prog = LmProgram(cfg, cache_len=38, max_new=6, prefill_buckets=(8, 32))
    eng = LmEngine(EngineConfig(prog, n_slots=4), params, device=cuda)
    for i in range(3):
        eng.open().push(np.arange(1, 5 + i, dtype=np.int32))
    assert eng._step()                          # warm-up
    with guards.compilation_budget(0, "warmed decode step"):
        for _ in range(3):
            assert eng._step()
        torch.cuda.synchronize()
    assert [len(eng._gen[s]) for s in range(3)] == [5, 5, 5]


def test_asr_and_lm_workers_serve_at_once_under_the_guard(cuda):
    """The `--serve` shape: an ASR and an LM engine on the card behind
    one EngineServer, two streams and three generations at once.  The
    guard (the process's sync debug mode in error) is open during every
    ASR step and LM decode while the other worker reads out, uploads and
    prefills; the workers take turns on the card, so no worker raises,
    dies or restarts, and every result equals its run on an engine of
    its own."""
    import asyncio

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import asr_demo_engine
    from repro_torch.models import LM
    from repro_torch.serving import EngineConfig, LmEngine, LmProgram
    from repro_torch.serving.server import (AsrClient, EngineServer,
                                            lm_generate)

    cfg = get_config("h2o-danube-1.8b").tiny()
    params = LM(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    prog = LmProgram(cfg, cache_len=38, max_new=6, prefill_buckets=(8, 32))

    def lm_engine(n_slots):
        return LmEngine(EngineConfig(prog, n_slots=n_slots), params,
                        device=cuda)
    asr, _ = asr_demo_engine(2, device=cuda)
    rng = np.random.default_rng(0)
    n = asr.plan.samples_per_step * 9 + 400
    audios = [rng.standard_normal(n).astype(np.float32) * 0.1
              for _ in range(2)]
    prompts = [list(range(1, 5 + i)) for i in range(3)]

    async def stream(server, audio):
        client = await AsrClient.open(server.host, server.port)
        for off in range(0, len(audio), 1280):
            assert (await client.push(audio[off:off + 1280]))["ok"]
        return await client.finish()

    async def go(server):
        await server.start()
        try:
            outs = await asyncio.gather(
                *[stream(server, a) for a in audios],
                *[lm_generate(server.host, server.port, p)
                  for p in prompts])
            alive = {role: w.is_alive() for role, w in server._workers()}
            return outs, alive, dict(server._restarts)
        finally:
            await server.aclose()

    outs, alive, restarts = asyncio.run(go(
        EngineServer(asr_engine=asr, lm_engine=lm_engine(2))))
    assert alive == {"asr": True, "lm": True}
    assert restarts == {"asr": 0, "lm": 0}
    assert guards._owners == {} and guards._turn is None
    solo, _ = asr_demo_engine(1, device=cuda)
    for audio, final in zip(audios, outs[:2]):
        assert "error" not in final, final
        want = solo.open().push(audio).finish()
        assert final["words"] == np.asarray(want["words"]).tolist()
        assert final["score"] == pytest.approx(want["score"], rel=1e-3)
    want = lm_engine(1).serve([np.asarray(p, np.int32) for p in prompts])
    for out, tokens in zip(outs[2:], want):
        assert out["done"] and out["tokens"] == list(tokens)
