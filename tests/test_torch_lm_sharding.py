"""The port's LM sharding rules against the JAX package's, on the CPU.

`parallel/sharding.py`'s `_param_rule` / `param_shardings` (bf16 trees
and their `quantize_params_for_serving` images: the `wq`/`wscale`
rules), `cache_shardings`, `batch_shardings` and `launch/steps.py`'s
`_opt_shardings_like`, leaf for leaf, on fake meshes: the production
(16, 16) and (2, 16, 16) and the small (2, 2) and (1, 4).  No ranks are
needed: the rules read only the mesh's axis names and sizes.  The
reference side runs on `compat.abstract_mesh` meshes (its
`NamedSharding`s need one); the port's on the same names and sizes.

Specs compare exactly, as `tuple(PartitionSpec)` normalizes them (a
one-name tuple is the name, an empty one None) and padded with None to
the leaf's rank.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.compat import abstract_mesh  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ASSIGNED_ARCHS, ShapeSpec as JShape  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import LM as JLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.parallel import sharding as tsh  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}


def _norm(spec, ndim: int) -> tuple:
    """A spec as JAX normalizes it, padded with None to `ndim`."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = None if not e else e[0] if len(e) == 1 else e
        out.append(e)
    return tuple(out) + (None,) * (ndim - len(out))


def _meshes(name):
    sizes, names = MESHES[name]
    return (abstract_mesh(sizes, names),
            SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes))))


def _jax_paths(tree, leaf_type=None):
    """{path of string keys: leaf} of a JAX tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=None if leaf_type is None
        else (lambda x: isinstance(x, leaf_type)))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            leaf for path, leaf in flat}


def _port_paths(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_paths(v, path + (k,)))
        return out
    return {path: tree}


_SHAPES = {}


def _shapes(arch: str, int8: bool):
    """(reference param shapes, port param shapes) of the full config."""
    key = (arch, int8)
    if key not in _SHAPES:
        jshapes = JLM(jget_config(arch)).param_shapes()
        tshapes = LM(get_config(arch)).param_shapes()
        if int8:
            jshapes = jax.eval_shape(jlayers.quantize_params_for_serving,
                                     jshapes)
            tshapes = tlayers.quantize_params_for_serving(tshapes)
        _SHAPES[key] = (jshapes, tshapes)
    return _SHAPES[key]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_shardings_match_reference(arch, mesh, int8):
    """Every leaf's spec, the reference's `param_shardings` against the
    port's, on the bf16 tree and the int8 serving tree (`wq` as `w`,
    `wscale` as `w` without its contraction dimension)."""
    jmesh, tmesh = _meshes(mesh)
    jshapes, tshapes = _shapes(arch, int8)
    want = _jax_paths(jsh.param_shardings(jget_config(arch), jshapes, jmesh),
                      jax.sharding.NamedSharding)
    got = _port_paths(tsh.param_shardings(get_config(arch), tshapes, tmesh))
    shapes = _port_paths(tshapes)
    assert set(got) == set(want) == set(shapes)
    jleaves = _jax_paths(jshapes)
    n_split = 0
    for path, spec in got.items():
        assert tuple(shapes[path].shape) == tuple(jleaves[path].shape), path
        nd = len(shapes[path].shape)
        assert spec == _norm(want[path].spec, nd), (path, spec,
                                                    want[path].spec)
        n_split += any(e is not None for e in spec)
    assert n_split >= len(got) // 3
    if int8:
        assert any(p[-1] == "wscale" and "model" not in s
                   and any(e is not None for e in s)
                   for p, s in got.items()) or mesh == "1x4"


# the four archs of the reference's test_cache_rules_divisible at their
# decode cells, and tiny decode shapes (a batch that divides the batch
# axes and one that does not: the sequence then splits over data too)
CACHE_CASES = [(a, False) for a in ("qwen2-72b", "jamba-v0.1-52b",
                                    "mamba2-1.3b",
                                    "llama4-maverick-400b-a17b")] + [
    (a, True) for a in ("h2o-danube-1.8b", "qwen2-moe-a2.7b", "mamba2-1.3b",
                        "jamba-v0.1-52b")]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,tiny", CACHE_CASES)
def test_cache_shardings_match_reference(arch, tiny, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg, tcfg = jget_config(arch), get_config(arch)
    if tiny:
        jcfg, tcfg = jcfg.tiny(), tcfg.tiny()
        shapes = [(b, 64) for b in (4, 3)]
    else:
        shapes = [(s.global_batch, s.seq_len) for s in jcfg.shapes()
                  if s.is_decode]
    for b, s in shapes:
        jc = jsteps.cache_specs(JLM(jcfg), JShape("d", s, b, "decode"))
        want = _jax_paths(jsh.cache_shardings(jcfg, jc, jmesh, b),
                          jax.sharding.NamedSharding)
        tc = tsteps.cache_specs(LM(tcfg), ShapeSpec("d", s, b, "decode"))
        got = _port_paths(tsh.cache_shardings(tcfg, tc, tmesh, b))
        leaves = _port_paths(tc)
        assert set(got) == set(want)
        for path, spec in got.items():
            nd = leaves[path].dim()
            assert spec == _norm(want[path].spec, nd), (b, s, path, spec,
                                                        want[path].spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_shardings_match_reference(mesh):
    """Inputs of train, prefill and decode cells, token and embedding
    archs, batches that divide the batch axes and batches that do not."""
    jmesh, tmesh = _meshes(mesh)
    for arch in ("h2o-danube-1.8b", "qwen2-vl-7b"):
        for b in (1, 3, 32, 256):
            for kind in ("train", "prefill", "decode"):
                jb = jsteps.input_specs(jget_config(arch),
                                        JShape("c", 64, b, kind))
                tb = tsteps.input_specs(get_config(arch),
                                        ShapeSpec("c", 64, b, kind))
                want = jsh.batch_shardings(jb, jmesh)
                got = tsh.batch_shardings(tb, tmesh)
                assert got.keys() == want.keys() == tb.keys()
                for k in got:
                    assert tuple(tb[k].shape) == tuple(jb[k].shape)
                    assert got[k] == _norm(want[k].spec, tb[k].dim()), (
                        arch, b, kind, k)


@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("mesh", ["16x16", "2x2"])
def test_opt_shardings_like_match_reference(mesh, moments):
    """AdamW state specs: each moment inherits its parameter's rule by
    path (int8 moments' q/scale stripped), the count whole."""
    jmesh, tmesh = _meshes(mesh)
    arch = "qwen2-moe-a2.7b"
    jcfg, tcfg = jget_config(arch).tiny(), get_config(arch).tiny()
    opt = jax.eval_shape(lambda p: jadamw.init(
        p, jadamw.AdamWConfig(moment_dtype=moments)),
        JLM(jcfg).param_shapes())
    want = _jax_paths(jsteps._opt_shardings_like(jcfg, opt, jmesh),
                      jax.sharding.NamedSharding)
    meta = {path: torch.empty(leaf.shape, device="meta")
            for path, leaf in _jax_paths(opt).items()}
    tree = {}
    for path, leaf in meta.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    got = _port_paths(tsteps._opt_shardings_like(tcfg, tree, tmesh))
    assert set(got) == set(want)
    for path, spec in got.items():
        assert spec == _norm(want[path].spec, meta[path].dim()), path


def test_local_block_and_gather_of_combined_axes():
    """A dimension split over ("data", "model") is the rank's row-major
    block of the two; `Sharder` layouts name the reference's axes."""
    x = torch.arange(16 * 3).reshape(16, 3)
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 4})

    def at(d, m):
        def axis(entry):
            names = entry if isinstance(entry, tuple) else (entry,)
            coords = {"data": d, "model": m}
            size = int(np.prod([mesh.shape[n] for n in names]))
            index = 0
            for n in names:
                index = index * mesh.shape[n] + coords[n]
            return SimpleNamespace(size=size, index=index)
        return SimpleNamespace(axis=axis, **vars(mesh))
    blocks = [tsh.local_block(x, (("data", "model"), None), at(d, m))
              for d in range(2) for m in range(4)]
    assert torch.equal(torch.cat(blocks), x)
    assert torch.equal(tsh.local_block(x, ("model", None), at(1, 2)), x[8:12])
    sh = tsh.Sharder(None)
    assert sh.mesh is None and sh.batch == () and sh.model is None
