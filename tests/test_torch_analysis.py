"""repro-lint for the port (`src/repro_torch/analysis`) and its runtime
guards.

* Parity: the engine rules (RPL003 aliasing, RPL004 thread discipline,
  RPL008 commit discipline), the suppression syntax and the CLI's
  baseline and GitHub formats give the same findings through
  `repro.analysis` and `repro_torch.analysis`, on fixtures and on the
  port's `serving/`.
* Rules: each port rule on a positive, a clean and a suppressed fixture;
  RPL001 on minimal copies of the two host reads the port's dry run
  found (a decode step's cache slot indexed by a 0-d tensor, `bincount`
  in the MoE dispatch), RPL006 on the reference's partial-product class
  written on `linear_row`.
* Self-run: the port's linter over `src/repro_torch` (0 findings), the
  reference's over `src/` (0 findings, the port included), the port's
  config registry, and the live kernel registry.
* Guards: `no_implicit_transfers(strict=True)` on host reads; the
  guard's per-thread state, the card's turns and the release of an
  abandoned thread (the mode setter recorded); and warmed
  engine steps under the engines' own guard made strict: fp32 and int8
  ASR, a 2-rank gloo world's data-sharded and model-sharded ASR step, an
  LM decode step.
"""
import contextlib
import functools
import pathlib
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import run_paths as ref_run_paths  # noqa: E402
from repro.analysis.__main__ import main as ref_main  # noqa: E402
from repro_torch.analysis import guards, run_paths  # noqa: E402
from repro_torch.analysis.__main__ import main  # noqa: E402
from repro_torch.analysis.core import RULE_DOCS  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def lint(tmp_path, source, name="snippet.py", rules=None, runner=run_paths):
    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return runner([str(path)], rules=rules, root=tmp_path)


def codes(findings):
    return [f.code for f in findings]


def keys(findings):
    return [(f.code, f.path, f.line) for f in findings]


# ---------------------------------------------------------------------------
# parity: RPL003 / RPL004 / RPL008 and the suppression syntax
# ---------------------------------------------------------------------------

POLL_ALIASING = """
    class Eng:
        def _poll(self, session):
            if session.admitted:
                res = self.slot_best(session.slot)
                res["steps"] = 1
                return res
            return {"steps": 0}
"""

THREADED = """
    def worker_only(fn):
        return fn

    class Eng:
        @worker_only
        def _advance_pool(self):
            pass

    async def handler(eng, worker):
        {call}
"""

SUPERVISED = """
    def worker_only(fn):
        return fn

    class Eng:
        @worker_only
        def _fail_all(self, exc):
            pass

    class Server:
        def {name}(self, eng, worker, exc):
            {call}
"""

# the commit-discipline fixtures both linters read alike: a fault probe
# and a callee that raises are may-raise in both
RAISING = """
    def validate(x):
        if x is None:
            raise ValueError("no input")
        return x

    class Eng:
        def step(self, slot, x):
{body}
"""

PARITY = {
    "rpl003 poll aliasing": (POLL_ALIASING, ["RPL003"]),
    "rpl003 state in dict and set_result": ("""
        class Eng:
            def snapshot(self, slot):
                return {"beam": self._beam, "n": 3}

            def resolve(self, fut, sess):
                fut.set_result(sess.result)
    """, ["RPL003", "RPL003"]),
    "rpl003 clean through copy_result": ("""
        from repro_torch.serving.engine import copy_result

        class Eng:
            def _poll(self, session):
                res = self.slot_best(session.slot)
                res["steps"] = 1
                return copy_result(res)

            def tokens(self, slot):
                return list(self._gen[slot])
    """, []),
    "rpl003 suppressed file-wide":
        ("# repro-lint: disable-file=RPL003\n" + textwrap.dedent(POLL_ALIASING),
         []),
    "rpl004 direct async call":
        (THREADED.format(call="eng._advance_pool()"), ["RPL004"]),
    "rpl004 clean through a worker thunk": (THREADED.format(
        call="await worker.call(lambda eng: eng._advance_pool())"), []),
    "rpl004 suppressed": (THREADED.format(
        call="eng._advance_pool()  # repro-lint: disable=RPL004"), []),
    "rpl004 watchdog entry point": (SUPERVISED.format(
        name="_watchdog_restart", call="eng._fail_all(exc)"), ["RPL004"]),
    "rpl004 clean watchdog thunk": (SUPERVISED.format(
        name="_supervise_restart",
        call="worker.submit(lambda e: e._fail_all(exc))"), []),
    "rpl004 unrelated sync function": (SUPERVISED.format(
        name="drive_inprocess", call="eng._fail_all(exc)"), []),
    "rpl008 mutation before a fault probe": ("""
        class Eng:
            def admit(self, sess):
                self._beam.append(sess)
                self._faults.check("admit")
    """, ["RPL008"]),
    "rpl008 mutation before a raising callee": (RAISING.format(body="""
            self._slot_bufs[slot] = None
            self._stream_state = validate(x)"""), ["RPL008"]),
    "rpl008 clean call then commit": (RAISING.format(body="""
            new = validate(x)
            self._stream_state = new
            self._slot_bufs[slot] = None"""), []),
    "rpl008 clean restoring handler": (RAISING.format(body="""
            saved = self._slot_bufs[slot]
            self._slot_bufs[slot] = None
            try:
                validate(x)
            except Exception:
                self._slot_bufs[slot] = saved
                raise"""), []),
    "rpl008 suppressed above the call": (RAISING.format(body="""
            self._slot_bufs[slot] = None
            # repro-lint: disable=RPL008
            self._stream_state = validate(x)"""), []),
}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_engine_rules_match_the_reference(tmp_path, name):
    source, want = PARITY[name]
    rules = ["RPL003", "RPL004", "RPL008"]
    got, got_s = lint(tmp_path, source, rules=rules)
    ref, ref_s = lint(tmp_path, source, rules=rules, runner=ref_run_paths)
    assert codes(got) == want
    assert keys(got) == keys(ref)
    assert keys(got_s) == keys(ref_s)
    if "suppressed" in name:
        assert got_s


def test_engine_rules_match_the_reference_across_files(tmp_path):
    """A may-raise callee two files away, suppressed at its hazard line:
    the related-location form of the syntax."""
    (tmp_path / "disp.py").write_text(textwrap.dedent("""
        def dispatch(eng, slot):
            if slot is None:
                raise ValueError(slot)  # repro-lint: disable=RPL008
            return slot
    """))
    (tmp_path / "eng.py").write_text(textwrap.dedent("""
        from disp import dispatch

        class Eng:
            def reset(self, slot):
                self._slot_bufs[slot] = None
                dispatch(self, slot)
    """))
    paths = [str(tmp_path / "eng.py"), str(tmp_path / "disp.py")]
    got = run_paths(paths, rules=["RPL008"], root=tmp_path)
    ref = ref_run_paths(paths, rules=["RPL008"], root=tmp_path)
    assert got[0] == [] and codes(got[1]) == ["RPL008"]
    assert keys(got[1]) == keys(ref[1]) and ref[0] == []


def test_engine_rules_match_the_reference_on_the_port_serving():
    rules = ["RPL003", "RPL004", "RPL008"]
    paths = [str(PORT / "serving")]
    got, got_s = run_paths(paths, rules=rules, root=REPO)
    ref, ref_s = ref_run_paths(paths, rules=rules, root=REPO)
    assert keys(got) == keys(ref) == []
    assert keys(got_s) == keys(ref_s)


BAD = textwrap.dedent(POLL_ALIASING)


@pytest.mark.parametrize("fmt", ["text", "github"])
def test_cli_formats_and_baseline_match_the_reference(tmp_path, capsys, fmt):
    bad = tmp_path / "bad.py"
    bad.write_text(BAD)
    outs = {}
    for name, cli in (("port", main), ("ref", ref_main)):
        base = tmp_path / f"{name}-baseline.json"
        rcs = [cli([str(bad), "--rules", "RPL003", "--format", fmt])]
        rcs.append(cli([str(bad), "--rules", "RPL003", "--baseline",
                        str(base), "--update-baseline"]))
        rcs.append(cli([str(bad), "--rules", "RPL003", "--format", fmt,
                        "--baseline", str(base)]))
        outs[name] = (rcs, capsys.readouterr().out.replace(
            f"{name}-baseline", "BASELINE"))
    assert outs["port"] == outs["ref"]
    rcs, out = outs["port"]
    assert rcs == [1, 0, 0] and "1 baselined" in out
    assert ("::error file=" in out) == (fmt == "github")


def test_cli_suppressed_and_exit_codes(tmp_path, capsys):
    sup = tmp_path / "sup.py"
    sup.write_text("# repro-lint: disable-file=RPL003\n" + BAD)
    assert main([str(sup), "--show-suppressed"]) == 0
    out = capsys.readouterr().out
    assert "[suppressed] " in out and "1 suppressed" in out
    assert main([str(sup), "--format", "github", "--show-suppressed"]) == 0
    assert "::notice file=" in capsys.readouterr().out
    assert main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    assert all(code in listed for code in RULE_DOCS)


def test_rule_docs_cover_the_eight_codes():
    from repro.analysis.core import RULE_DOCS as REF_DOCS
    assert sorted(RULE_DOCS) == sorted(REF_DOCS) == [
        f"RPL00{i}" for i in range(1, 9)]


# ---------------------------------------------------------------------------
# RPL001 — host reads in a guarded step (a 0-d index, bincount)
# ---------------------------------------------------------------------------

CACHE_SLOT = """
    import torch
    from repro_torch.analysis.guards import no_implicit_transfers

    class LM:
        def init_cache(self, n):
            return {{"kpos": torch.full((n,), -1), "offset": torch.zeros(())}}

        def decode_step(self, params, cache, batch):
            kpos = cache["kpos"].clone()
            offset = cache["offset"]
            slot = offset % kpos.shape[-1]
            {write}
            return {{"kpos": kpos, "offset": offset + 1}}

    class Engine:
        def __init__(self):
            self.lm = LM()

        def _step(self):
            with no_implicit_transfers(){supp}
                self.cache = self.lm.decode_step(self.params, self.cache, {{}})
"""

MOE_BINCOUNT = """
    import torch
    from repro_torch.analysis.guards import no_implicit_transfers

    def dispatch(flat_e, n_experts, cap):
        order = torch.argsort(flat_e, stable=True)
        counts = {count}
        starts = torch.cumsum(counts, 0) - counts
        return order, counts, starts

    def apply_moe(x, flat_e):
        return dispatch(flat_e, 8, 4)

    class Engine:
        def _step(self):
            with no_implicit_transfers():
                out = apply_moe(self.x, self.flat_e)
            return out
"""


@pytest.mark.parametrize("case", ["write", "clean", "suppressed"])
def test_rpl001_cache_slot_by_a_0d_tensor(tmp_path, case):
    write = ("kpos.index_put_((slot.long().reshape(1),), offset.reshape(1))"
             if case == "clean" else "kpos[slot] = offset")
    supp = ":  # repro-lint: disable=RPL001" if case == "suppressed" else ":"
    findings, suppressed = lint(tmp_path, CACHE_SLOT.format(
        write=write, supp=supp), rules=["RPL001"])
    if case == "write":
        assert codes(findings) == ["RPL001"]
        assert "0-d tensor" in findings[0].message
        assert "decode_step" in findings[0].message
        assert findings[0].related        # the guarded block's line
    else:
        assert findings == []
        assert codes(suppressed) == (["RPL001"] if case == "suppressed"
                                     else [])


@pytest.mark.parametrize("case", ["bincount", "clean"])
def test_rpl001_bincount_in_the_moe_dispatch(tmp_path, case):
    count = ("torch.bincount(flat_e, minlength=n_experts)"
             if case == "bincount" else
             "torch.zeros(n_experts, dtype=torch.long).scatter_add_("
             "0, flat_e, torch.ones_like(flat_e))")
    findings, _ = lint(tmp_path, MOE_BINCOUNT.format(count=count),
                       rules=["RPL001"])
    if case == "bincount":
        assert codes(findings) == ["RPL001"]
        assert "bincount" in findings[0].message
    else:
        assert findings == []


def test_rpl001_readbacks_branches_and_reach(tmp_path):
    findings, _ = lint(tmp_path, """
        import torch
        from repro_torch.analysis.guards import no_implicit_transfers

        def deep(t: torch.Tensor):
            return t.tolist()

        def mid(t: torch.Tensor):
            return deep(t)

        def scores(x: torch.Tensor, n: int):
            best = x.max()
            if best > 0:
                x = x - best
            k = int(x.sum())
            if n > 2:
                return torch.nonzero(x), mid(x), k
            return torch.where(x > 0), x.cpu()

        class Eng:
            def _step(self):
                with no_implicit_transfers():
                    out = scores(self.x, 3)
                    v = out[0].item()
                return v
    """, rules=["RPL001"])
    got = sorted(f.message.split(" in `")[0] for f in findings)
    assert got == ["Python `if` on a tensor", "`.cpu()` on a tensor",
                   "`.item()` on a tensor", "`.tolist()` on a tensor",
                   "`int()` of a tensor", "`nonzero` (its output is sized "
                   "by the data)", "one-argument `torch.where` (a nonzero)"]


def test_rpl001_index_by_a_0d_parameter(tmp_path):
    """A 0-d tensor parameter, seen through its callers: every call site
    passes a full reduction."""
    findings, _ = lint(tmp_path, """
        import torch
        from repro_torch.analysis.guards import no_implicit_transfers

        def write(kpos, slot, n):
            kpos[slot] = n
            kpos[n] = 0

        def step(kpos, x: torch.Tensor):
            with no_implicit_transfers():
                write(kpos, x.argmax(), 3)
    """, rules=["RPL001"])
    assert [(f.line, "0-d tensor" in f.message) for f in findings] == \
        [(6, True)]


def test_rpl001_reach_stops_two_levels_below_the_block(tmp_path):
    findings, _ = lint(tmp_path, """
        import torch
        from repro_torch.analysis.guards import no_implicit_transfers

        def l3(t: torch.Tensor):
            return t.item()

        def l2(t):
            return l3(t)

        def l1(t):
            return l2(t)

        def l0(t):
            return l1(t)

        def step(t):
            with no_implicit_transfers():
                return l0(t)
    """, rules=["RPL001"])
    assert findings == []          # l3 is three levels below l0


# ---------------------------------------------------------------------------
# RPL002 / RPL007 — the kernel contract
# ---------------------------------------------------------------------------

WRAPPER = """
    import torch

    from pkg.kernels import _build, ref

    launches = 0


    def foo(x, scale):
        global launches
        if not x.is_cuda:
            return ref.foo(x, scale)
        {grad}
        {require}
        out = torch.empty_like(x)
        err = _build.lib().foo_launch(x.data_ptr(), out.data_ptr(),
                                      float(scale))
        _build.check(err, "foo")
        launches += 1
        return out
"""

REGISTRY = """
KERNEL_REGISTRY = {{{supp}
    "foo": {{
        "replaces": "src/repro/kernels/foo.py:1",
        "entry_points": ["foo_launch"{extra_ep}],
        "wrapper": "foo",
        "counters": ["launches"],
        "entry": ["{entry}"],
        "ref": ["foo"],
        "cost": ["foo"],
        "test": ["tests/test_torch_kernels.py"],
        "cuda_test": "tests/test_torch_cuda_kernels.py",
    }},
}}
"""


def kernel_tree(tmp_path, grad=True, require=True, narrow=False,
                extra_ep="", extra_cu=False, supp=""):
    k = tmp_path / "pkg" / "kernels"
    (k / "csrc").mkdir(parents=True)
    (k / "policy.py").write_text(REGISTRY.format(
        supp=supp, extra_ep=extra_ep, entry="foo"))
    (k / "_build.py").write_text(textwrap.dedent("""
        SIGNATURES = {"foo_launch": (1, 2, 3)}

        def lib():
            return None

        def refuse_grad(name, *ts):
            pass

        def require(t, name, dtype, ndim, device):
            pass

        def check(err, name):
            pass
    """))
    (k / "ref.py").write_text("def foo(x, scale):\n    return x * scale\n")
    (k / "ops.py").write_text(textwrap.dedent("""
        from pkg.kernels import cost as _cost, foo as _foo

        @_cost.fused("foo")
        def foo(x, scale, policy=None):
            return _foo.foo(x, scale)
    """))
    wrapper = textwrap.dedent(WRAPPER.format(
        grad='_build.refuse_grad("foo", x)' if grad else "pass",
        require=('_build.require(x, "x", torch.float32, 2, x.device)'
                 if require else "pass")))
    if narrow:          # the entry drops the twin's `scale`
        wrapper = wrapper.replace("def foo(x, scale):", "def foo(x):") \
            .replace("scale", "1.0")
    (k / "foo.py").write_text(wrapper)
    (k / "csrc" / "foo.cu").write_text(
        'extern "C" int foo_launch(void* x, void* o, float s) { return 0; }\n')
    if extra_cu:
        (k / "csrc" / "bar.cu").write_text("// no registry entry\n")
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_torch_kernels.py").write_text(
        "def test_foo():\n    pass\n")
    (tmp_path / "tests" / "test_torch_cuda_kernels.py").write_text(
        "import pytest\npytestmark = pytest.mark.cuda\n\n"
        "def test_foo_kernel():\n    pass\n")
    return run_paths([str(tmp_path / "pkg")], rules=["RPL002", "RPL007"],
                     root=tmp_path)


def test_rpl002_rpl007_clean_with_the_full_contract(tmp_path):
    assert kernel_tree(tmp_path) == ([], [])


@pytest.mark.parametrize("case,code,text", [
    ("extra_cu", "RPL002", "bar.cu has no KERNEL_REGISTRY entry"),
    ("no_grad", "RPL002", "refuse_grad"),
    ("bad_ep", "RPL002", "not a key of _build.SIGNATURES"),
    ("no_require", "RPL007", "_build.require"),
    ("signature", "RPL007", "matches no registered plain twin"),
])
def test_rpl002_rpl007_fire_on_a_broken_contract(tmp_path, case, code, text):
    findings, _ = kernel_tree(
        tmp_path, grad=case != "no_grad", require=case != "no_require",
        extra_ep=', "gone_launch"' if case == "bad_ep" else "",
        extra_cu=case == "extra_cu", narrow=case == "signature")
    assert {f.code for f in findings} == {code}, \
        [f.format() for f in findings]
    assert any(text in f.message for f in findings)


def test_rpl002_suppressed_at_the_registry(tmp_path):
    findings, suppressed = kernel_tree(
        tmp_path, extra_cu=True, supp="  # repro-lint: disable=RPL002")
    assert findings == [] and codes(suppressed) == ["RPL002"]


def test_rpl007_suppressed_at_the_launch(tmp_path):
    findings, suppressed = kernel_tree(tmp_path, require=False)
    assert codes(findings) == ["RPL007"]
    wrapper = tmp_path / "pkg" / "kernels" / "foo.py"
    lines = wrapper.read_text().splitlines()
    at = findings[0].line - 1
    lines[at] += "  # repro-lint: disable=RPL007"
    wrapper.write_text("\n".join(lines) + "\n")
    findings, suppressed = run_paths([str(tmp_path / "pkg")],
                                     rules=["RPL007"], root=tmp_path)
    assert findings == [] and codes(suppressed) == ["RPL007"]


# ---------------------------------------------------------------------------
# RPL005 — RNG discipline on a mesh
# ---------------------------------------------------------------------------

SHARDED_INIT = """
    import torch
    from repro_torch.launch.mesh import reduce_from

    def init(mesh, n, g):
        w = {draw}
        return reduce_from(w, mesh.axis("model"))
"""


@pytest.mark.parametrize("draw,want", [
    ("torch.randn(n, n)", ["RPL005"]),
    ("torch.randn(n, n, generator=g)", []),
    ("torch.empty(n, n).normal_()", ["RPL005"]),
    ("torch.manual_seed(0)", ["RPL005"]),
    ("torch.Generator().manual_seed(0)", []),
])
def test_rpl005_global_generator_in_sharded_module(tmp_path, draw, want):
    findings, _ = lint(tmp_path, SHARDED_INIT.format(draw=draw),
                       rules=["RPL005"])
    assert codes(findings) == want


def test_rpl005_clean_without_sharded_compute_and_suppressed(tmp_path):
    findings, _ = lint(tmp_path, "import torch\nw = torch.randn(3)\n",
                       rules=["RPL005"])
    assert findings == []
    findings, suppressed = lint(tmp_path, SHARDED_INIT.format(
        draw="torch.randn(n, n)  # repro-lint: disable=RPL005"),
        rules=["RPL005"])
    assert findings == [] and codes(suppressed) == ["RPL005"]


# ---------------------------------------------------------------------------
# RPL006 — mesh axes and partial products (on linear_row)
# ---------------------------------------------------------------------------

AXES = """
    from repro_torch.launch import mesh as meshlib

    def step(mesh, x):
        return meshlib.reduce_from(x, mesh.axis("model"))

    def build(x):
        {supp}
        mesh = meshlib.make_mesh((2, 1), {names})
        return step(mesh, x)
"""


@pytest.mark.parametrize("names,supp,want", [
    ('("data", "expert")', "", ["RPL006"]),
    ('("data", "model")', "", []),
    ('("data", "expert")', "# repro-lint: disable=RPL006", []),
])
def test_rpl006_mesh_axis_the_mesh_declares(tmp_path, names, supp, want):
    findings, suppressed = lint(tmp_path, AXES.format(names=names, supp=supp),
                                rules=["RPL006"])
    assert codes(findings) == want
    if want:
        assert "'model'" in findings[0].message and findings[0].related
    if supp:
        assert codes(suppressed) == ["RPL006"]


PARTIAL_LINEAR_ROW = """
    import torch
    from repro_torch.launch import mesh as meshlib
    from repro_torch.parallel.sharding import local_block

    def linear_row(p, x, axis):
        y = torch.matmul(x.float(), p["w"].float())
        {reduce}
        return y.to(x.dtype)

    def block(p, x, mesh):
        xl = local_block(x, (None, "model"), mesh)
        return linear_row(p, xl, mesh.axis("model")){supp}
"""


@pytest.mark.parametrize("reduce,supp,want", [
    ("pass", "", ["RPL006"]),
    ("y = meshlib.reduce_from(y, axis)", "", []),
    ("axis.all_reduce(y)", "", []),
    ("pass", "  # repro-lint: disable=RPL006", []),
])
def test_rpl006_partial_product_on_linear_row(tmp_path, reduce, supp,
                                                  want):
    findings, suppressed = lint(tmp_path, PARTIAL_LINEAR_ROW.format(
        reduce=reduce, supp=supp), rules=["RPL006"])
    assert codes(findings) == want
    if want:
        assert "partial sum" in findings[0].message
    if supp:
        assert codes(suppressed) == ["RPL006"]


def test_rpl006_unguarded_mesh_shape_lookup(tmp_path):
    findings, _ = lint(tmp_path, """
        def split(mesh, size):
            return size // mesh.shape["model"]

        def guarded(mesh, size):
            if "model" in mesh.axis_names:
                return size // mesh.shape["model"]
            return size
    """, rules=["RPL006"])
    assert codes(findings) == ["RPL006"] and findings[0].line == 3


# ---------------------------------------------------------------------------
# RPL008 — the port's may-raise dispatch calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("body,want", [
    ("self._slot_steps[slots] += 1\n"
     "        self._run_step(self._stream_state, slots)", ["RPL008"]),
    ("self._tokens = tok\n"
     "        self.lm.decode_step(self.params, self.cache, {})", ["RPL008"]),
    ("self.cache = {}\n"
     "        _build.lib().foo_launch(x.data_ptr())", ["RPL008"]),
    ("new = self._run_step(self._stream_state, slots)\n"
     "        self._stream_state = new", []),
    ("self._slot_steps[slots] += 1\n"
     "        self._run_step(self._stream_state, slots)"
     "  # repro-lint: disable=RPL008", []),
])
def test_rpl008_port_dispatch_calls_may_raise(tmp_path, body, want):
    findings, _ = lint(tmp_path, f"""
class Eng:
    def step(self, slots, tok, x):
        {body}
""", rules=["RPL008"])
    assert codes(findings) == want


# ---------------------------------------------------------------------------
# self-run and the live registry
# ---------------------------------------------------------------------------

def test_self_run_over_the_port_is_clean(capsys):
    assert main([str(PORT)]) == 0
    assert capsys.readouterr().out.startswith("0 finding(s), 0 baselined")


def test_reference_linter_over_src_stays_clean():
    """The CI's run, `python -m repro.analysis src/`: the port's code,
    its analysis package included, trips none of the reference's
    rules."""
    findings, _ = ref_run_paths([str(REPO / "src")], root=REPO)
    assert findings == [], "\n".join(f.format() for f in findings)


def test_port_config_registry_has_no_dead_modules(capsys):
    from repro_torch.analysis.imports import config_usage
    usage = config_usage(REPO)
    assert len(usage) >= 10
    assert [u.module for u in usage if u.dead] == []
    assert all(u.module.startswith("repro_torch.configs.") for u in usage)
    assert main(["--config-usage", str(REPO)]) == 0
    assert "[DEAD]" not in capsys.readouterr().out


def test_live_registry_covers_the_tpu_kernels_and_the_sources():
    import ast
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.policy import KERNEL_REGISTRY
    tree = ast.parse((PORT / "kernels" / "policy.py").read_text())
    literal = next(ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign)
                   and n.targets[0].id == "KERNEL_REGISTRY")
    assert literal == KERNEL_REGISTRY
    assert set(KERNEL_REGISTRY) == {f.stem for f in _build.sources()}
    # the seven functions of the reference that reach pl.pallas_call
    pallas = {}
    for f in sorted((REPO / "src" / "repro" / "kernels").glob("*.py")):
        for node in ast.parse(f.read_text()).body:
            if isinstance(node, ast.FunctionDef) and any(
                    isinstance(n, ast.Attribute) and n.attr == "pallas_call"
                    for n in ast.walk(node)):
                pallas[f"src/repro/kernels/{f.name}:{node.lineno}"] = \
                    node.name
    assert len(pallas) == 7, pallas
    assert {e["replaces"] for e in KERNEL_REGISTRY.values()} == set(pallas)
    eps = [ep for e in KERNEL_REGISTRY.values() for ep in e["entry_points"]]
    assert sorted(eps) == sorted(_build.SIGNATURES)
    counters = {c for e in KERNEL_REGISTRY.values() for c in e["counters"]}
    assert counters == {"launches", "rmsnorm_launches"}
    assert {n for e in KERNEL_REGISTRY.values() for n in e["cost"]} == \
        set(ops.KERNEL_MODULES)


# ---------------------------------------------------------------------------
# the runtime guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("read", ["item", "0-d index", "bincount", "int",
                                  "bool", "tolist", "mask"])
def test_strict_guard_raises_on_host_reads(read):
    x = torch.arange(6.0)
    fn = {"item": lambda: x.sum().item(),
          "0-d index": lambda: x[torch.tensor(2)],
          "bincount": lambda: torch.bincount(x.long()),
          "int": lambda: int(x[0]),
          "bool": lambda: bool((x > 2).any()),
          "tolist": lambda: x.tolist(),
          "mask": lambda: x[x > 2]}[read]
    with pytest.raises(guards.HostSyncError):
        with guards.no_implicit_transfers(strict=True):
            fn()
    assert guards._owners == {}


def test_strict_guard_lets_device_work_and_lifted_transfers_through():
    a, b = torch.randn(4, 3), torch.randn(3, 2)
    with guards.no_implicit_transfers(strict=True):
        y = torch.matmul(a, b)
        z = torch.zeros(4, dtype=torch.long).scatter_add_(
            0, torch.tensor([0, 1, 1]), torch.ones(3, dtype=torch.long))
        with guards.no_implicit_transfers():          # nests
            w = y.index_select(0, torch.tensor([1]))
        with guards.allow_transfers():
            n = int(z.sum())                          # explicit: lifted
    assert n == 3 and w.shape == (1, 2)
    assert guards._owners == {}


def test_guard_sets_and_restores_the_sync_debug_mode(monkeypatch):
    """The card's half, with torch.cuda's mode setter recorded: a block
    sets error, a lift inside it the mode from before the block, the
    outermost exit restores that mode, and a lift outside every block
    (a collective off the engines' steps) touches nothing."""
    mode, log = ["warn"], []

    def set_mode(m):
        if m not in ("default", "warn", "error"):
            raise RuntimeError("invalid argument to set_sync_debug_mode")
        mode[0] = m
        log.append(m)
    monkeypatch.setattr(guards, "_has_cuda", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    with guards.allow_transfers():
        pass
    assert log == []
    with guards.no_implicit_transfers():
        assert mode == ["error"]
        with guards.no_implicit_transfers():
            guards.lift()                      # an async collective
            assert mode == ["warn"]
        assert mode == ["warn"]                # still lifted
        guards.unlift()
        assert mode == ["error"]
    assert mode == ["warn"] and guards._owners == {}


def fake_card_mode(monkeypatch, start="default"):
    """torch.cuda's sync debug mode, recorded: ([the mode], [each set])."""
    mode, log = [start], []

    def set_mode(m):
        mode[0] = m
        log.append(m)
    monkeypatch.setattr(guards, "_has_cuda", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    return mode, log


def in_thread(fn):
    """Run `fn` on a thread of its own; returns (thread, its result)."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(10)
    assert not t.is_alive()
    return t, out[0] if out else None


def test_guard_state_is_per_thread_and_set_only_on_change(monkeypatch):
    """A lift on one thread does not lift another thread's block; the
    mode is set once when a block opens, not again for a nested block,
    twice for a lift inside it, and once when the last block closes."""
    mode, log = fake_card_mode(monkeypatch)
    with guards.no_implicit_transfers():
        with guards.no_implicit_transfers():
            assert log == ["error"]
        in_thread(lambda: guards.allow_transfers().__enter__())
        assert mode == ["error"]           # the other thread's lift
        with guards.allow_transfers():
            assert mode == ["default"]
        assert log == ["error", "default", "error"]
    assert mode == ["default"] and log[-1] == "default" and len(log) == 4
    guards._owners.clear()                 # the other thread's open lift


def test_released_thread_leaves_the_guard_and_the_turn(monkeypatch):
    """A thread abandoned inside a block and holding the card's turn
    (a wedged worker): `release` closes its block and hands its turn to
    the waiting thread; what the released thread does later counts for
    nothing."""
    mode, _ = fake_card_mode(monkeypatch)
    entered, wake, done = (threading.Event() for _ in range(3))

    def wedged():
        with guards.card_turn(), guards.no_implicit_transfers():
            entered.set()
            wake.wait(10)
        with guards.no_implicit_transfers():     # after its release
            assert guards._owners == {}
        done.set()
    old = threading.Thread(target=wedged)
    old.start()
    assert entered.wait(10) and mode == ["error"]
    beats = []

    def waiter():
        with guards.card_turn(lambda: beats.append(1)):
            return guards._turn is threading.current_thread()
    new = threading.Thread(target=lambda: beats.append(waiter()))
    new.start()
    while not beats:                       # waiting, and saying so
        time.sleep(0.01)
    assert guards._turn is old
    guards.release(old)
    new.join(10)
    assert beats[-1] is True and mode == ["default"]
    with guards.card_turn():               # free again
        wake.set()
        assert done.wait(10)
        assert guards._turn is threading.current_thread()
    old.join(10)
    assert guards._owners == {} and guards._turn is None
    assert mode == ["default"]


def test_card_turns_are_exclusive_and_in_order():
    """Threads holding the card's turn never overlap, take it in the
    order they asked, and a thread may re-enter its own turn."""
    inside, order, gate = [], [], threading.Event()

    def work(i):
        if i == 0:
            with guards.card_turn():
                gate.set()
                time.sleep(0.05)
                with guards.card_turn():           # re-entrant
                    order.append(i)
            return
        gate.wait(10)
        time.sleep(0.01 * i)
        with guards.card_turn():
            inside.append(i)
            assert len(inside) == 1
            order.append(i)
            time.sleep(0.01)
            inside.remove(i)
    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert order == [0, 1, 2, 3] and guards._turn is None


def test_compilation_budget_counts_kernel_library_builds(tmp_path,
                                                         monkeypatch):
    """A forced rebuild (a fresh build directory) runs nvcc: a fake one
    here, which writes the files it is asked for."""
    from repro_torch.kernels import _build
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then shift; : > \"$1\"; fi\n"
                    "  shift\ndone\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with guards.compilation_budget(0, "warmed"):
        pass
    with guards.count_compilations() as counter:
        _build.build()
        _build.build()              # the same sources: loaded as built
    assert counter.count == 1
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels2")
    with pytest.raises(AssertionError, match="compilation budget exceeded"):
        with guards.compilation_budget(0, "warmed step"):
            _build.build()


@contextlib.contextmanager
def strict_engine_guard(module):
    """The engine's own guard, made strict: yields the list of blocks the
    engine opened."""
    real, entered = module.no_implicit_transfers, []

    def guard():
        entered.append(1)
        return real(strict=True)
    module.no_implicit_transfers = guard
    try:
        yield entered
    finally:
        module.no_implicit_transfers = real


def demo_audio(eng, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(eng.plan.samples_per_step * 9 + 400)
            .astype(np.float32) * 0.1 for _ in range(n)]


@pytest.mark.parametrize("use_int8", [False, True])
def test_warmed_asr_step_passes_the_strict_guard(use_int8):
    from repro_torch.launch.serve import asr_demo_engine
    from repro_torch.serving import asr as asrmod
    eng, _ = asr_demo_engine(4, device="cpu", use_int8=use_int8)
    for s, audio in enumerate(demo_audio(eng, 4)):
        eng.feed_slot(s, audio)
    assert eng._step()                          # warm-up
    with strict_engine_guard(asrmod) as entered:
        assert eng._step()
    assert entered == [1]
    assert eng.step_shapes[0] == eng.step_shapes[1]


def test_warmed_lm_decode_step_passes_the_strict_guard():
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serving import EngineConfig, LmEngine, LmProgram
    from repro_torch.serving import lm as lmmod
    cfg = get_config("h2o-danube-1.8b").tiny()
    params = LM(cfg).init(torch.Generator().manual_seed(0))
    prog = LmProgram(cfg, cache_len=38, max_new=6, prefill_buckets=(8, 32))
    eng = LmEngine(EngineConfig(prog, n_slots=4), params, device="cpu")
    for i in range(3):
        eng.open().push(np.arange(1, 5 + i, dtype=np.int32))
    assert eng._step()                          # warm-up
    with strict_engine_guard(lmmod) as entered:
        assert eng._step()
    assert entered == [1]
    assert [len(eng._gen[s]) for s in range(3)] == [3, 3, 3]


def test_guarded_asr_steps_on_a_two_rank_mesh(tmp_path):
    """A 2-rank gloo world: one warmed step of the 'data'-sharded pool
    (2x1) and of the 'model'-sharded contraction (2) under the strict
    guard (the contraction's all-reduces lift it), equal to the same
    steps without it."""
    import _torch_mesh_ranks as ranks
    from repro_torch.launch.serve import asr_demo_engine
    eng, _ = asr_demo_engine(4, device="cpu")
    utts = demo_audio(eng, 4, seed=1)
    outs = ranks.run(2, tmp_path, "guarded_step",
                     {"meshes": ("2x1", "2"), "utts": utts})
    for out in outs:
        for spec in ("2x1", "2"):
            r = out[spec]
            assert r["entered"] == 1, (spec, r)
            assert r["blocks_left"] == 0 and r["lifts_left"] == 0
            assert r["words"] == r["unguarded_words"]
    assert outs[0]["2x1"]["words"] == outs[1]["2x1"]["words"]
