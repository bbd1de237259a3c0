"""The port's checkpoint files against the JAX package's, on the CPU.

``repro_torch.checkpoint.io`` writes the JAX package's npz layout, so a
file written by either package loads in the other bit for bit: a
12-entry list (numeric, not lexicographic, leaf order), bf16 leaves
(stored as their uint16 bits, no ``ml_dtypes`` in the port), keys that
hold ``__`` or look like the sentinels, metadata, and the trainer state
``{"lkv", "opt": AdamState}`` (the NamedTuple as the tuple of its
fields).  A tree that does not match the file raises, a file of the
older mangled-key layout loads, and ``load_lookahead_params`` takes both
layouts the trainers write.  No JAX compile: only ``jax.numpy`` arrays
and the JAX checkpoint module.
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs import get_smoke_config as jax_smoke
from repro.core.lookahead import init_lookahead_params as jax_init_lkv
from repro.models import transformer as jtf
from repro.optim import adam as jadam
from repro_torch import bridge
from repro_torch.checkpoint import io as tckpt
from repro_torch.configs import get_smoke_config
from repro_torch.core.lookahead import (init_lookahead_params,
                                        load_lookahead_params,
                                        lookahead_count)
from repro_torch.optim import adam as tadam


def _np_bits(x) -> np.ndarray:
    """A leaf of either package as (dtype name, raw bytes as uint8)."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).replace("torch.", "")
        return name, x.detach().contiguous().reshape(-1).view(
            torch.uint8).numpy()
    a = np.asarray(x)
    return str(a.dtype), a.reshape(-1).view(np.uint8)


def _assert_bits_equal(jax_tree, torch_tree):
    jflat = jckpt._flatten(jax_tree)
    tflat = tckpt._flatten(torch_tree)
    assert list(jflat) == list(tflat)
    for k in jflat:
        (jd, jb), (td, tb) = _np_bits(jflat[k]), _np_bits(tflat[k])
        assert jd == td, (k, jd, td)
        assert tuple(np.shape(jflat[k])) == tuple(tflat[k].shape), k
        np.testing.assert_array_equal(jb, tb, err_msg=k)


def _trees():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "list12": {"layers": [np.full((3, 2), i, np.float32) + i / 7.0
                              for i in range(12)]},
        "bf16": {"w": f32(4, 5), "s": np.asarray(3, np.int32),
                 "h": f32(2, 3)},
        "dunder": {"w__a": np.arange(4, dtype=np.float32),
                   "__meta__": np.ones((2,), np.float32),
                   "nested": {"x__y__z": np.full((3,), 7.0, np.float32)}},
    }


def _as_jax(tree, bf16=()):
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(
            x, jnp.bfloat16 if str(getattr(p[-1], "key", "")) in bf16
            else x.dtype), tree)


def _as_torch(tree):
    """The same tree as tensors (lists kept as lists)."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    return bridge.to_torch({"x": np.asarray(tree)}, device="cpu")["x"]


@pytest.mark.parametrize("name", ["list12", "bf16", "dunder"])
def test_jax_file_loads_in_port_and_back(tmp_path, name):
    jtree = _as_jax(_trees()[name], bf16=("w", "h"))
    meta = {"arch": "smoke", "step": 5}
    p_j = str(tmp_path / "jax.npz")
    jckpt.save(p_j, jtree, metadata=meta)
    like = _as_torch(jax.tree.map(lambda x: np.zeros(x.shape, np.float32),
                                  jtree))
    back = tckpt.load(p_j, like=like)
    _assert_bits_equal(jtree, back)
    assert tckpt.metadata(p_j) == meta
    assert set(tckpt.load(p_j)) == set(jckpt.load(p_j))
    # port -> JAX
    p_t = str(tmp_path / "port.npz")
    tckpt.save(p_t, back, metadata=meta)
    again = jckpt.load(p_t, like=jax.tree.map(jnp.zeros_like, jtree))
    _assert_bits_equal(again, back)
    assert jckpt.metadata(p_t) == meta
    if name == "list12":
        for i, leaf in enumerate(back["layers"]):
            assert float(leaf[0, 0]) == pytest.approx(i + i / 7.0)
    if name == "bf16":
        assert back["w"].dtype == torch.bfloat16
        assert again["w"].dtype == jnp.bfloat16


def _lkv_pair():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    lkv = jax_init_lkv(jax.random.PRNGKey(1), jcfg, params["layers"])
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params),
                              device="cpu")
    return jcfg, tcfg, params, lkv, tparams


def _jax_state(lkv):
    st = jadam.init(lkv)
    return st._replace(step=jnp.asarray(17, jnp.int32),
                       mu=jax.tree.map(lambda x: x + 0.5, st.mu),
                       nu=jax.tree.map(lambda x: x + 2.0, st.nu))


def test_trainer_state_crosses_both_ways(tmp_path):
    """``{"lkv", "opt": AdamState}``: the JAX trainer's file into the
    port's AdamState, and the port's file into JAX's."""
    _, tcfg, _, lkv, tparams = _lkv_pair()
    jtree = {"lkv": lkv, "opt": _jax_state(lkv)}
    p = str(tmp_path / "state.npz")
    jckpt.save(p, jtree, metadata={"step": 17})
    tl = init_lookahead_params(torch.Generator().manual_seed(0), tcfg,
                               tparams["layers"])
    back = tckpt.load(p, like={"lkv": tl, "opt": tadam.init(tl)})
    assert isinstance(back["opt"], tadam.AdamState)
    assert back["opt"].step.dtype == torch.int32
    assert int(back["opt"].step) == 17
    _assert_bits_equal(jtree, back)
    p2 = str(tmp_path / "state_port.npz")
    tckpt.save(p2, back, metadata={"step": 17})
    again = jckpt.load(p2, like={"lkv": lkv, "opt": jadam.init(lkv)})
    assert isinstance(again["opt"], jadam.AdamState)
    _assert_bits_equal(again, back)


def test_mismatched_tree_raises(tmp_path):
    p = str(tmp_path / "m.npz")
    tckpt.save(p, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="mismatch"):
        tckpt.load(p, like={"b": torch.ones(2)})
    with pytest.raises(ValueError, match="mismatch at a"):
        tckpt.load(p, like={"a": torch.ones(3)})


def test_load_lookahead_params_both_layouts(tmp_path):
    """A JAX-written bare lkv tree and a JAX-written trainer state load as
    the same modules, on the device asked for, bit for bit."""
    _, tcfg, _, lkv, tparams = _lkv_pair()
    bare = str(tmp_path / "bare.npz")
    state = str(tmp_path / "state.npz")
    jckpt.save(bare, lkv)
    jckpt.save(state, {"lkv": lkv, "opt": _jax_state(lkv)})
    a = load_lookahead_params(bare, tcfg, tparams["layers"], device="cpu")
    b = load_lookahead_params(state, tcfg, tparams["layers"], device="cpu")
    _assert_bits_equal(lkv, a)
    _assert_bits_equal(lkv, b)
    assert a["emb"].device.type == "cpu"
    assert lookahead_count(a) == sum(int(x.size)
                                     for x in jax.tree.leaves(lkv))


def test_legacy_layout_loads(tmp_path):
    """A file of the older layout (path keys mangled "/" -> "__" into the
    member names, no ``__keys__`` manifest, no metadata) loads by its
    unmangled paths, bf16 included."""
    import json

    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    bf = bridge.to_torch({"x": np.asarray(jnp.asarray(w, jnp.bfloat16))},
                         device="cpu")["x"]
    arrays = {"lora__wq__a": w,
              "emb": bf.view(torch.int16).numpy().view(np.uint16),
              "__dtypes__": np.frombuffer(json.dumps(
                  {"lora/wq/a": "float32", "emb": "bfloat16"}).encode(),
                  dtype=np.uint8)}
    p = str(tmp_path / "legacy.npz")
    np.savez(p, **arrays)
    flat = tckpt.load(p)
    assert set(flat) == {"lora/wq/a", "emb"}
    back = tckpt.load(p, like={"emb": torch.zeros(2, 3),
                               "lora": {"wq": {"a": torch.zeros(2, 3)}}})
    assert back["emb"].dtype == torch.bfloat16
    assert torch.equal(back["emb"].view(torch.int16), bf.view(torch.int16))
    np.testing.assert_array_equal(back["lora"]["wq"]["a"].numpy(), w)
    assert tckpt.metadata(p) == {}
