"""The port's sharded ASR serving step vs the unsharded engines of both
packages, on the CPU.

Meshes of 2 and 4 ranks run as spawned processes on a gloo world
(`_torch_mesh_ranks`), one module-scoped run per world size, each rank
serving the same utterances through `AsrEngine(EngineConfig(mesh=...))`;
the 1x1 mesh runs in this process (a one-rank mesh needs no world).
Both packages get the JAX demo system (`params_from_numpy`,
`Lexicon.from_numpy`) at beam 25, 4 slots, 6 utterances (slots reused,
ragged tails, so data shards step uneven groups).

Held: words and tokens equal, step counts equal; scores within 1e-3
(the reference's bound, tests/test_sharded_serving.py) of the port's
unsharded engine, since the 'model' all-reduce sums partial products in
another order, and bitwise at the 1x1 mesh and a data-only 2x1 mesh
(the same per-row products).  Against JAX's unsharded engine: fp32
scores within 1e-3; int8 scores within rtol 1e-2, the bound the port's
unsharded int8 engine is held to against JAX's
(tests/test_torch_engine.py: an activation one ulp from the reference's
can quantize to the neighbouring int8 value; here 0.061 on a score of
-28.1, on every mesh and without one).
"""
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.data.pipeline import SyntheticASR  # noqa: E402
from repro.kernels.policy import KernelPolicy as JaxPolicy  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.serving import AsrEngine as JaxEngine  # noqa: E402
from repro.serving import AsrProgram as JaxProgram  # noqa: E402
from repro.serving import EngineConfig as JaxConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import tds_asr as tcfg  # noqa: E402
from repro_torch.core import lexicon as tlx  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serving import (AsrProgram, EngineConfig,  # noqa: E402
                                 LmEngine, LmProgram)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLOTS, N_UTTS = 4, 6
SCORE_ATOL = 1e-3
INT8_JAX_RTOL = 1e-2
# (mesh, int8, overlap) served by each world
CASES = {2: [(m, q, False) for m in ("2", "2x1", "1x2") for q in (False, True)]
         + [("2", q, True) for q in (False, True)],
         4: [(m, q, False) for m in ("2x2", "4") for q in (False, True)]
         + [("2x2", q, True) for q in (False, True)]}
ALL_CASES = ([(1, ("1x1", q, False)) for q in (False, True)]
             + [(w, c) for w, cs in CASES.items() for c in cs])


def _port_system():
    """The JAX demo system, carried across to the port as numpy."""
    tds_cfg, words, lex, lm, params, dec = jserve.asr_demo_system()
    t_cfg = tcfg.TDSConfig(
        stages=tuple(tcfg.TDSStage(s.n_blocks, s.channels, s.feat, s.kernel,
                                   s.subsample) for s in tds_cfg.stages),
        vocab_size=tds_cfg.vocab_size)
    t_lex = tlx.Lexicon.from_numpy(np.asarray(lex.children),
                                   np.asarray(lex.child_token),
                                   np.asarray(lex.word_id), lex.n_nodes,
                                   lex.max_children)
    t_lm = tlx.BigramLM.from_numpy(np.asarray(lm.table), lm.n_words)
    t_dec = tcfg.DecoderConfig(**dec.__dict__)
    t_params = jax.tree.map(np.asarray, params)
    return t_cfg, words, t_lex, t_lm, t_params, t_dec


@pytest.fixture(scope="module")
def system():
    return _port_system()


@pytest.fixture(scope="module")
def utterances(system):
    data = SyntheticASR(system[1])
    return [data.utterance(u)["audio"] for u in range(N_UTTS)]


def _port_engine(system, int8=False, mesh=None, overlap=False, n=N_SLOTS):
    eng, _ = tserve.asr_demo_engine(n, device="cpu", system=system,
                                    use_int8=int8, mesh=mesh,
                                    overlap_psum=overlap)
    return eng


@pytest.fixture(scope="module")
def unsharded(system, utterances):
    """{int8: (results, step_shapes)} of the port's unsharded engine."""
    out = {}
    for q in (False, True):
        eng = _port_engine(system, q)
        out[q] = (eng.serve(utterances), list(eng.step_shapes))
    return out


@pytest.fixture(scope="module")
def jax_unsharded(utterances):
    tds_cfg, _, lex, lm, params, dec = jserve.asr_demo_system()
    out = {}
    for q in (False, True):
        prog = JaxProgram(tds_cfg, lex, lm, dec_cfg=dec,
                          use_int8=q).with_beam_width(25.0)
        out[q] = JaxEngine(JaxConfig(prog, n_slots=N_SLOTS,
                                     kernels=JaxPolicy("ref")),
                           params).serve(utterances)
    return out


@pytest.fixture(scope="module")
def served(system, utterances, tmp_path_factory):
    """{world: [each rank's {case: ...}]}; world 1 is the in-process 1x1
    mesh."""
    out = {}
    for world, cases in CASES.items():
        out[world] = ranks.run(
            world, tmp_path_factory.mktemp(f"serve{world}"), "serve",
            {"system": system, "utts": utterances, "n_slots": N_SLOTS,
             "cases": cases})
    mesh = meshlib.make_mesh((1, 1), ("data", "model"))
    one = {}
    for q in (False, True):
        eng = _port_engine(system, q, mesh)
        one[("1x1", q, False)] = {
            "results": eng.serve(utterances),
            "step_shapes": list(eng.step_shapes),
            "pool_rows": next(iter(eng._stream_state.values())).shape[0],
            "slot_buckets": eng._slot_buckets}
    out[1] = [one]
    return out


def _same_transcripts(got, want, score_atol, score_rtol=0.0):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["words"], w["words"], err_msg=str(i))
        np.testing.assert_array_equal(g["tokens"], w["tokens"],
                                      err_msg=str(i))
        if score_atol == score_rtol == 0:
            assert g["score"] == w["score"], i
        else:
            assert abs(g["score"] - w["score"]) < max(
                score_atol, score_rtol * abs(w["score"])), (
                i, g["score"], w["score"])
        if "steps" in w:
            assert g["steps"] == w["steps"], i


@pytest.mark.parametrize("world,case", ALL_CASES,
                         ids=[f"{c[0]}-{'int8' if c[1] else 'fp32'}"
                              f"{'-overlap' if c[2] else ''}"
                              for _, c in ALL_CASES])
def test_sharded_engine_matches_unsharded_engines(served, unsharded,
                                                  jax_unsharded, world, case):
    """Every rank of every mesh returns the same results, equal to the
    port's unsharded engine (bitwise at 1x1 and 2x1, where no
    contraction is split) and to JAX's unsharded engine (see the module
    docstring for int8), with the same step schedule."""
    spec, int8, _ = case
    want, want_shapes = unsharded[int8]
    exact = spec in ("1x1", "2x1")
    for r in served[world]:
        got = r[case]
        _same_transcripts(got["results"], want, 0 if exact else SCORE_ATOL)
        _same_transcripts(got["results"], jax_unsharded[int8], SCORE_ATOL,
                          INT8_JAX_RTOL if int8 else 0.0)
        assert [n for n, _, w in got["step_shapes"]] == [
            n for n, _, w in want_shapes]
        assert [w for _, _, w in got["step_shapes"]] == [
            w for _, _, w in want_shapes]
    assert any(len(r["tokens"]) for r in want)


@pytest.mark.parametrize("world,case", [(1, ("1x1", False, False)),
                                        (2, ("2x1", False, False)),
                                        (4, ("2x2", False, False)),
                                        (2, ("2", False, False))])
def test_data_axis_splits_the_pool(served, unsharded, world, case):
    """With a 'data' axis each rank holds n_slots / n_data pool rows and
    buckets its per-shard group, so every step's batch is a multiple of
    n_data rows; a 1D ('model',) mesh keeps the whole pool (and the
    unsharded buckets) on every rank."""
    spec = case[0]
    n_data = int(spec.split("x")[0]) if "x" in spec else 1
    for r in served[world]:
        got = r[case]
        assert got["pool_rows"] == N_SLOTS // n_data
        assert got["slot_buckets"][-1] == N_SLOTS // n_data
        assert all(b % n_data == 0 for _, b, _ in got["step_shapes"])
    if spec in ("1x1", "2"):
        assert served[world][0][case]["step_shapes"] == unsharded[False][1]


def test_assemble_batch_is_shard_aligned(served):
    """Slots {0, 1, 3} on a 2x1 mesh of 4 slots (2 a shard): shard 0's
    at rows [0, 2), shard 1's at [2, 4), the pad row zeros with index
    -1 (tests/test_sharded_serving.py's expectations); assembly does not
    consume the windows, `_retire` does."""
    for r in served[2]:
        a = r["assemble"]
        assert a["slots_per_shard"] == 2
        assert a["batch"].shape[:2] == (4, 1)
        assert a["idx"].tolist() == [0, 1, 3, -1]
        np.testing.assert_array_equal(a["batch"][0], 1.0)
        np.testing.assert_array_equal(a["batch"][1], 2.0)
        np.testing.assert_array_equal(a["batch"][2], 4.0)
        np.testing.assert_array_equal(a["batch"][3], 0.0)
        assert a["before"] == [1, 1, 1] and a["after"] == [0, 0, 0]


def test_pad_row_writes_nothing(system, utterances):
    """Three eligible slots of 4 on a 1x1 mesh step at bucket 4: the pad
    row (index -1, reading pool row 0) must leave slot 3's state alone.
    torch's index_put wraps -1 to the last row, which is slot 3: the
    engine writes back only the real rows."""
    probe = torch.zeros(4)
    assert probe.index_put((torch.tensor([-1]),), torch.ones(1))[3] == 1
    eng = _port_engine(system, mesh=meshlib.make_mesh((1, 1),
                                                      ("data", "model")))
    for s in range(3):
        eng.feed_slot(s, utterances[s])
    # slot 3's left context, marked: a wrapped write would overwrite it
    eng._stream_state = {k: v.index_fill(0, torch.tensor([3]), 7.0)
                         for k, v in eng._stream_state.items()}
    keep = ({k: v.clone() for k, v in eng._stream_state.items()},
            [x.clone() for x in eng._beam])
    _, idx = eng._assemble_batch([0, 1, 2], 1)
    assert idx.tolist() == [0, 1, 2, -1]
    assert eng._step()
    assert eng.step_shapes[-1][:2] == (3, 4)
    for k, v in keep[0].items():
        assert torch.equal(eng._stream_state[k][3], v[3]), k
        assert not torch.equal(eng._stream_state[k][:3], v[:3]), k
    for got, want in zip(eng._beam, keep[1]):
        assert torch.equal(got[3], want[3])


# ---------------------------------------------------------------------------
# configuration, the launcher
# ---------------------------------------------------------------------------
def _stub(names, shape):
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)),
                           size=int(np.prod(shape)))


@pytest.mark.parametrize("names,shape,n_slots,match", [
    (("data",), (1,), 2, "needs a 'model' axis"),
    (("replica", "model"), (1, 1), 2, r"extra axes \['replica'\]"),
    (("data", "model"), (2, 1), 3, r"n_slots=3 must divide evenly over the "
                                   r"'data' mesh axis \(size 2\)")])
def test_engine_config_mesh_validation_matches_reference(system, names,
                                                         shape, n_slots,
                                                         match):
    tds_cfg, _, lex, lm, _, dec = jserve.asr_demo_system()
    jprog = JaxProgram(tds_cfg, lex, lm, dec_cfg=dec)
    tprog = AsrProgram(system[0], system[2], system[3], dec_cfg=system[5])
    for cfg_cls, prog in ((JaxConfig, jprog), (EngineConfig, tprog)):
        with pytest.raises(ValueError, match=match):
            cfg_cls(prog, n_slots=n_slots, mesh=_stub(names, shape))


@pytest.mark.parametrize("knob", ["session_deadline", "worker_watchdog"])
def test_wall_clock_knobs_are_refused_under_a_multi_rank_mesh(system, knob):
    """The two wall-clock knobs were refused under a mesh of several ranks
    until rank 0 alone came to decide them (its deadline reaps and
    watchdog restarts reach the other ranks through its command stream,
    tests/test_torch_serve_mesh.py): no longer refused, on a 2x1 mesh as
    on a one-rank mesh."""
    prog = AsrProgram(system[0], system[2], system[3], dec_cfg=system[5])
    two = _stub(("data", "model"), (2, 1))
    one = meshlib.make_mesh((1, 1), ("data", "model"))
    for mesh in (two, one):
        assert getattr(EngineConfig(prog, n_slots=2, mesh=mesh,
                                    **{knob: 5.0}), knob) == 5.0


def test_lm_engine_rejects_a_mesh():
    cfg = get_config("mamba2-1.3b").tiny()
    prog = LmProgram(cfg, cache_len=24, max_new=8)
    mesh = meshlib.make_mesh((1,), ("model",))
    with pytest.raises(NotImplementedError, match="ASR"):
        LmEngine(EngineConfig(prog, mesh=mesh), params=None, device="cpu")


def test_serve_mesh_specs_and_errors(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tserve.serve_mesh("1") is None and tserve.serve_mesh(0) is None
    m = tserve.serve_mesh("1x1", "cpu")
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 1, "model": 1}
    for spec, match in (("2x", "expected N or RxC"),
                        ("0x2", "axes must be >= 1"),
                        ("2", "torchrun --nproc-per-node 2"),
                        ("2x2", "torchrun --nproc-per-node 4")):
        with pytest.raises(SystemExit, match=match):
            tserve.serve_mesh(spec, "cpu")


@pytest.mark.parametrize("argv", [["--mode", "lm", "--mesh", "2"],
                                  ["--serve", "--mesh", "2x2"]])
def test_launcher_refuses_a_mesh_outside_asr(argv, capsys, monkeypatch):
    """`--mode lm --mesh` is refused for good (LmEngine takes no mesh, as
    the reference's).  `--serve --mesh 2x2` is served now, but in a
    one-rank world `serve_mesh` exits naming the launch it needs instead
    of serving unsharded."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit) as exc:
        tserve.main(argv + ["--device", "cpu"])
    if argv[0] == "--serve":
        assert "torchrun --nproc-per-node 4" in str(exc.value)
    else:
        assert "--mesh" in capsys.readouterr().err


def _utt_lines(text):
    return [ln.split(" steps=")[1] for ln in text.splitlines()
            if ln.startswith("utt ")]


def test_launcher_mesh2_prints_the_unsharded_transcripts(capsys):
    """`torchrun --nproc-per-node 2 ... --mesh 2 --device cpu` prints (on
    rank 0 only) the transcripts that `--mesh 1` prints."""
    tserve.main(["--mode", "asr", "--streams", "2", "--device", "cpu"])
    want = _utt_lines(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--mode", "asr", "--streams", "2", "--mesh", "2", "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert len(want) == 2 and _utt_lines(r.stdout) == want, r.stdout
    assert "backend gloo" in r.stdout and "(2 ranks" in r.stdout
