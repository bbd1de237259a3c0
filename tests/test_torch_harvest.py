"""The port's data half of the learning loop against the JAX package's, on
the CPU: the synthetic training mixture, the prefix-shared serving trace
and the trace harvest.

* ``MixtureIterator`` (synthetic answers, and answers generated by the
  model, greedy and sampled) and ``make_prefix_trace`` give arrays equal
  to JAX's for the same seed: the numpy streams are kept draw for draw,
  including the key the sampler draws;
* ``harvest_trace`` on the float32 llama3-8b smoke model (JAX parameters
  bridged) serves the same trace through the port's ``ContinuousEngine``
  under h2o and writes the same records: ``x`` and ``y`` exactly, every
  gt score within 1e-5 of its (layer, head) row's largest;
* ``HarvestIterator`` is deterministic, the writer appends after the
  shards already there, and a JAX-written shard directory trains the
  port (``launch/train.py --harvest``).
"""

import torch_test_env  # noqa: F401  (first: process settings)
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data import harvest as jharvest
from repro.data import synthetic as jsyn
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.lookahead import init_lookahead_params
from repro_torch.data import harvest as tharvest
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train
from repro_torch.models import transformer as ttf

HARVEST = dict(requests=4, policy="h2o", budget=32, chunk=16, max_new=4,
               max_obs=4, num_slots=2, seed=3)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jax_smoke("llama3-8b"), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                               dtype="float32")
    params = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=params,
                tp=bridge.to_torch(jax.tree.map(np.asarray, params),
                                   device="cpu"))


@pytest.fixture(scope="module")
def harvests(model, tmp_path_factory):
    """The same trace harvested by both packages."""
    jdir = str(tmp_path_factory.mktemp("jax_harvest"))
    tdir = str(tmp_path_factory.mktemp("port_harvest"))
    jw = jharvest.harvest_trace(model["jp"], model["jcfg"], out_dir=jdir,
                                **HARVEST)
    tw = tharvest.harvest_trace(model["tp"], model["tcfg"], out_dir=tdir,
                                **HARVEST)
    assert jw.records_written == tw.records_written == HARVEST["requests"]
    return jdir, tdir


def _assert_batches_equal(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.x.dtype == b.x.dtype == np.int32
    assert a.y.dtype == b.y.dtype == np.int32
    if a.answer_pos is None:
        assert b.answer_pos is None
    else:
        np.testing.assert_array_equal(a.answer_pos, b.answer_pos)


def test_mixture_matches_jax_with_synthetic_answers(model):
    j = jsyn.MixtureIterator(model["jcfg"], 3, 48, 10, seed=4)
    t = tsyn.MixtureIterator(model["tcfg"], 3, 48, 10, seed=4)
    for _ in range(8):  # every task kind comes up
        _assert_batches_equal(next(j), next(t))


def test_mixture_matches_jax_with_generated_answers(model):
    """Y decoded by the model on each side, greedily and sampled at
    temperature 0.7 from the key JAX draws from the stream; the streams
    stay in step (the next batch's prompts agree too)."""
    for temperature in (0.0, 0.7):
        j = jsyn.MixtureIterator(model["jcfg"], 2, 24, 4, seed=6,
                                 gen_params=model["jp"],
                                 temperature=temperature)
        t = tsyn.MixtureIterator(model["tcfg"], 2, 24, 4, seed=6,
                                 gen_params=model["tp"],
                                 temperature=temperature)
        for _ in range(3):
            _assert_batches_equal(next(j), next(t))


@pytest.mark.parametrize("kw", [{}, dict(chunk=256),
                                dict(n_prefixes=5, suffix_lens=(3, 9))])
def test_prefix_trace_matches_jax(kw):
    want = jsyn.make_prefix_trace(9, 12, 512, **kw)
    got = tsyn.make_prefix_trace(9, 12, 512, **kw)
    assert len(want) == len(got) == 12
    for (wp, wt), (gp, gt) in zip(want, got):
        np.testing.assert_array_equal(wp, gp)
        assert wp.dtype == gp.dtype and wt == gt


def test_harvest_trace_matches_jax(model, harvests):
    jdir, tdir = harvests
    want, got = jharvest.load_records(jdir), tharvest.load_records(tdir)
    assert len(want) == len(got) == HARVEST["requests"]
    L, H = model["tcfg"].num_layers, model["tcfg"].attn.num_heads
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w["x"], g["x"])
        np.testing.assert_array_equal(w["y"], g["y"])
        assert g["s"].shape == (L, H, len(g["x"]))
        assert g["s"].dtype == np.float32
        tol = 1e-5 * np.abs(w["s"]).max(axis=-1, keepdims=True)
        assert np.all(np.abs(g["s"] - w["s"]) <= tol)


def test_iterator_is_deterministic(harvests):
    _, tdir = harvests
    a = tharvest.HarvestIterator(tdir, 2, seed=7)
    b = tharvest.HarvestIterator(tdir, 2, seed=7)
    j = jharvest.HarvestIterator(tdir, 2, seed=7)
    for _ in range(4):
        ba, bb, bj = next(a), next(b), next(j)
        assert ba["x"].shape[0] == 2 and ba["s_gt"].shape[1] == 2
        assert ba["s_gt"].shape[3] == ba["x"].shape[1]
        for k in ("x", "s_gt"):
            np.testing.assert_array_equal(ba[k], bb[k])
            np.testing.assert_array_equal(ba[k], bj[k])


def test_writer_appends_after_existing_shards(model, harvests,
                                              tmp_path):
    """A second harvest into a directory extends the dataset (shard_00001
    beside the JAX package's shard_00000) instead of clobbering it."""
    jdir, _ = harvests
    rec = jharvest.load_records(jdir)[0]
    out = str(tmp_path / "ds")
    shutil.copytree(jdir, out)
    w = tharvest.HarvestWriter(model["tp"], model["tcfg"],
                               tharvest.HarvestConfig(out_dir=out, max_obs=4))

    class _Req:
        prompt = rec["x"]
        out_tokens = [int(t) for t in rec["y"]]

    w.on_retire(_Req())
    w.flush()
    recs = tharvest.load_records(out)
    assert len(recs) == HARVEST["requests"] + 1
    np.testing.assert_array_equal(recs[-1]["x"], rec["x"])
    tol = 1e-5 * np.abs(rec["s"]).max(axis=-1, keepdims=True)
    assert np.all(np.abs(recs[-1]["s"] - rec["s"]) <= tol)


def test_jax_shards_train_the_port(harvests, tmp_path):
    jdir, _ = harvests
    out = train.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                      "--harvest", jdir, "--steps", "3", "--batch", "2",
                      "--seed", "1", "--ckpt", str(tmp_path / "lkv.npz")])
    assert len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"])) and all(
        g > 0 for g in out["grad_norms"])
    # the trainer's modules start from seed + 1 and moved
    cfg = get_smoke_config("llama3-8b")
    start = init_lookahead_params(
        torch.Generator().manual_seed(2), cfg,
        ttf.init_params(cfg, seed=1, device="cpu")["layers"])
    assert not torch.equal(start["emb"], out["lkv"]["emb"])
