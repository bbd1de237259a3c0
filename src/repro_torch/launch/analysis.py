"""Dry-run analysis of the port: roofline terms from analytic models and
from counts taken on the meta device (``launch/dryrun.py``).

Hardware constants: the NVIDIA H100 80GB HBM3 (SXM, 700 W) data sheet,
the card the port runs on.  The analytic functions (``roofline_terms``,
``model_flops``, ``analytic_hbm_bytes``, ``component_costs``,
``per_device_cost``) are the JAX package's ``launch/analysis.py`` with
these constants.  Its functions over compiled HLO and jaxprs have no
torch counterpart; their places are taken by:

* ``meta_flops`` for ``jaxpr_cost`` / ``fn_cost``: the step run once on
  meta tensors under ``torch.utils.flop_counter.FlopCounterMode`` (every
  matmul-like op counted, loops unrolled as the Python runs them);
* ``collective_bytes`` for ``collective_bytes`` /
  ``collective_bytes_with_loops``: the step run on one rank's meta
  shards with the port's two transports (``attention.all_gather_raw``,
  ``attention.all_reduce``) replaced by counters, so every gather and
  merge the step makes over the mesh is counted, layers included, and
  the backward's all-reduces of a training step too;
* ``memory_dict`` for ``memory_analysis_dict``: argument and output
  bytes per rank from the tensors the rank holds (torch has no compiled
  buffer plan, so there are no temporaries);
* ``cost_analysis_dict``: none.
"""

from __future__ import annotations

import contextlib
from dataclasses import asdict, dataclass

import torch

from repro_torch.common.pytree import tree_leaves

# --- NVIDIA H100 80GB HBM3 (SXM5, 700 W), data sheet -----------------------
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
LINK_BW = 450e9  # bytes/s per card each way over NVLink (4th generation)

@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # per device
    hlo_bytes: float  # per device (HBM traffic)
    coll_bytes: float  # per device
    model_flops: float  # 6·N_active·D tokens, global
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    useful_flop_ratio: float
    peak_bytes_per_device: float | None = None

    def to_dict(self):
        return asdict(self)


def roofline_terms(
    *, arch: str, shape: str, mesh: str, chips: int,
    hlo_flops_per_dev: float, hlo_bytes_per_dev: float,
    coll_bytes_per_dev: float, model_flops_global: float,
    peak_bytes: float | None = None,
) -> Roofline:
    compute_s = hlo_flops_per_dev / PEAK_FLOPS_BF16
    memory_s = hlo_bytes_per_dev / HBM_BW
    collective_s = coll_bytes_per_dev / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total_hlo = hlo_flops_per_dev * chips
    ratio = model_flops_global / total_hlo if total_hlo else 0.0
    return Roofline(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=hlo_flops_per_dev, hlo_bytes=hlo_bytes_per_dev,
        coll_bytes=coll_bytes_per_dev, model_flops=model_flops_global,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, useful_flop_ratio=ratio,
        peak_bytes_per_device=peak_bytes,
    )


def model_flops(cfg, shape_kind: str, tokens: int) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train ≈ fwd+bwd => 6; inference 2)."""
    n_active = cfg.active_params()
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n_active * tokens
# ---------------------------------------------------------------------------
# Analytic HBM traffic model
# ---------------------------------------------------------------------------
# Unavoidable HBM traffic of the implementation (the JAX package's model):
#   · weights read once per pass (MoE dense-dispatch: once per seq chunk);
#   · activations written+read once per layer boundary (~8 stream tensors);
#   · flash attention reads K/V once per query block-row;
#   · decode reads the whole KV cache once per step;
#   · train charges 2 passes (GT + lookahead) + lookahead-row backward.


def analytic_hbm_bytes(cfg, shape_kind: str, batch: int, seq: int) -> float:
    bpe = 2.0  # bf16
    d = cfg.d_model
    L = cfg.num_layers
    p_bytes = cfg.num_params() * bpe

    if shape_kind == "decode":
        tokens = batch  # one token per sequence
        cache = 0.0
        if cfg.attn is not None:
            cache = L * batch * seq * cfg.attn.kv_dim * 2 * bpe
        if cfg.uses_ssm:
            s = cfg.ssm
            nh = s.num_heads(d)
            cache += L * batch * nh * s.head_dim * s.d_state * 4 * 2  # r+w f32
        act = L * tokens * d * bpe * 8
        return p_bytes + cache + act + tokens * cfg.vocab_size * 4

    tokens = batch * seq
    passes = 2.0 if shape_kind == "train" else 1.0
    act = passes * L * tokens * d * bpe * 8
    attn_io = 0.0
    if cfg.attn is not None:
        block_q = 512.0
        qblocks = max(seq / block_q, 1.0)
        kv_read = seq * cfg.attn.kv_dim * 2 * bpe
        attn_io = passes * L * batch * qblocks * kv_read
        if cfg.attn.sliding_window and not cfg.attn.global_every:
            attn_io *= min(cfg.attn.sliding_window / seq * qblocks, 1.0)
    moe_reread = 0.0
    if cfg.moe is not None:
        m = cfg.moe
        nchunks = max(seq / 256.0, 1.0)  # moe._CHUNK
        expert_bytes = L * m.num_experts * 3 * d * m.d_expert * bpe
        moe_reread = passes * (nchunks - 1) * expert_bytes
    weight_reads = passes * p_bytes
    if shape_kind == "train":
        weight_reads += p_bytes  # backward re-reads (remat-ish)
    return weight_reads + act + attn_io + moe_reread


# ---------------------------------------------------------------------------
# Sharding-aware per-component cost model (the roofline numerators)
# ---------------------------------------------------------------------------
# Each component carries its own effective shard count from the same
# divisibility rules as ``common/sharding.py``; per-device cost =
# sum_c flops_c / (dp_shards * model_shards_c).  Cross-checked against
# the meta FLOP count (``meta_flops``).


def component_costs(cfg, shape_kind: str, batch: int, seq: int,
                    mesh_shape: dict, *, seq_sharded: bool = False) -> dict:
    """{component: {flops, bytes, model_shards}} — global flops/bytes and the
    model-axis parallelism each component actually achieves."""
    msize = mesh_shape.get("model", 1)
    a = cfg.attn
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    bpe = 2.0
    tokens = batch * (1 if shape_kind == "decode" else seq)

    # forward-pass multiplier: GT + lookahead passes for train (+ backward
    # through the lookahead rows ~ small); plain LM train = fwd + 2×bwd.
    if shape_kind == "train":
        passes = 2.2 if cfg.technique_applies else 3.0
    else:
        passes = 1.0

    def div(n, s):
        return s > 0 and n % s == 0

    comps = {}

    if a is not None:
        shard_q = div(a.num_heads, msize)
        shard_kv = div(a.num_kv_heads, msize)
        proj_flops = 2.0 * tokens * d * (a.q_dim * 2 + a.kv_dim * 2) * L
        comps["attn_proj"] = {
            "flops": passes * proj_flops,
            "bytes": passes * L * (d * (a.q_dim * 2 + a.kv_dim * 2)) * bpe,
            "model_shards": msize if shard_q else 1,
        }
        if shape_kind == "decode":
            ctx = seq
            quad = 4.0 * batch * ctx * a.q_dim * L
            kv_bytes = L * batch * ctx * a.kv_dim * 2 * bpe
        else:  # data-like traffic: scales with the local batch shard
            causal_frac = 0.5
            window = a.sliding_window if (a.sliding_window and
                                          not a.global_every) else 0
            eff_ctx = min(window, seq) if window else seq * causal_frac
            if a.global_every:
                n_glob = L // a.global_every
                eff_ctx = (min(a.sliding_window, seq) * (L - n_glob)
                           + seq * causal_frac * n_glob) / L
            quad = 4.0 * batch * seq * eff_ctx * a.q_dim * L
            kv_bytes = passes * L * batch * (seq / 512.0) \
                * eff_ctx * a.kv_dim * 2 * bpe
        comps["attn_quadratic"] = {
            "flops": passes * quad,
            "bytes": 0.0,
            "data_bytes": kv_bytes,
            "model_shards": msize if shard_q else 1,
        }
    if cfg.moe is not None:
        m = cfg.moe
        shard_e = div(m.num_experts, msize)
        if m.dispatch == "sparse":
            # top-k + capacity slack; weights stream once (no chunk re-read)
            dense_e = m.top_k * m.capacity_factor
            nchunks = 1.0
        else:
            dense_e = m.num_experts  # dense dispatch computes every expert
            nchunks = max((1 if shape_kind == "decode" else seq) / 256.0, 1.0)
        expert_flops = 2.0 * tokens * 3 * d * m.d_expert * dense_e * L
        expert_bytes = L * m.num_experts * 3 * d * m.d_expert * bpe * nchunks
        comps["moe_experts"] = {
            "flops": passes * expert_flops,
            "bytes": passes * expert_bytes,
            "model_shards": msize if shard_e else 1,
        }
        if m.num_shared_experts:
            fs = m.num_shared_experts * m.d_expert
            comps["moe_shared"] = {
                "flops": passes * 2.0 * tokens * 3 * d * fs * L,
                "bytes": passes * L * 3 * d * fs * bpe,
                "model_shards": msize if div(fs, msize) else 1,
            }
        comps["moe_router"] = {
            "flops": passes * 2.0 * tokens * d * m.num_experts * L,
            "bytes": passes * L * d * m.num_experts * 4,
            "model_shards": 1,
        }
    elif cfg.d_ff > 0:
        comps["mlp"] = {
            "flops": passes * 2.0 * tokens * 3 * d * cfg.d_ff * L,
            "bytes": passes * L * 3 * d * cfg.d_ff * bpe,
            "model_shards": msize if div(cfg.d_ff, msize) else 1,
        }
    if cfg.ssm is not None:
        s = cfg.ssm
        di = s.d_inner(d)
        nh = s.num_heads(d)
        proj = 2.0 * tokens * d * (2 * di + 2 * s.d_state + nh) \
            + 2.0 * tokens * di * d
        # SSD: intra-chunk quadratic + state updates
        Q = s.chunk_size
        ssd = (2.0 * tokens * Q * nh * s.head_dim  # cb/w application
               + 2.0 * tokens * Q * s.d_state  # C·B
               + 4.0 * tokens * nh * s.head_dim * s.d_state)
        comps["ssm"] = {
            "flops": passes * (proj + ssd) * L,
            "bytes": passes * L * (d * (2 * di + 2 * s.d_state + nh)
                                   + di * d) * bpe,
            "model_shards": 1,  # baseline: replicated
        }
    if cfg.is_encoder_decoder and shape_kind != "decode":
        F = cfg.encoder.num_frames
        enc_tokens = batch * F
        eL = cfg.encoder.num_layers
        enc = (2.0 * enc_tokens * d * (a.q_dim * 2 + a.kv_dim * 2)
               + 2.0 * enc_tokens * 3 * d * cfg.d_ff
               + 4.0 * enc_tokens * F * a.q_dim) * eL
        cross = (2.0 * tokens * d * a.q_dim * 2
                 + 4.0 * tokens * F * a.q_dim) * L
        comps["encoder_cross"] = {
            "flops": passes * (enc + cross),
            "bytes": passes * eL * (2 * d * (a.q_dim + a.kv_dim)
                                    + 3 * d * cfg.d_ff) * bpe,
            "model_shards": msize if div(cfg.d_ff, msize) else 1,
        }
    # logits / embeddings (the padded vocab always shards)
    Vp = getattr(cfg, "padded_vocab", V)
    if div(Vp, msize) or div(d, msize):
        lshard = msize
    else:
        lshard = 1
    logit_tokens = tokens if shape_kind != "train" else tokens  # 'all' logits
    if shape_kind == "train" and cfg.technique_applies:
        logit_tokens = 0  # KL objective needs no logits
    comps["logits"] = {
        "flops": 2.0 * logit_tokens * d * V,
        "bytes": V * d * bpe,
        "model_shards": lshard,
    }
    if seq_sharded:
        # sequence parallelism: every per-token component's *compute* shards
        # over the model axis too (weights are still read replicated — the
        # bytes keep their base shard counts).
        for c in comps.values():
            c["flops_shards"] = msize * max(c["model_shards"] // msize, 1) \
                if c["model_shards"] == msize else msize
    # decode cache traffic
    if shape_kind == "decode" and a is not None:
        kv_shards = msize if (div(a.num_kv_heads, msize) or
                              div(seq, msize)) else 1
        comps["kv_cache_io"] = {
            "flops": 0.0,
            "bytes": 0.0,
            "data_bytes": L * batch * seq * a.kv_dim * 2 * bpe,
            "model_shards": kv_shards,
        }
    return comps


def per_device_cost(comps: dict, mesh_shape: dict, global_batch: int) -> dict:
    """Fold components into per-device (flops, bytes) given batch sharding."""
    dp = 1
    for k, v in mesh_shape.items():
        if k != "model":
            dp *= v
    if global_batch % dp != 0:
        dp = mesh_shape.get("data", 1) if (
            global_batch % mesh_shape.get("data", 1) == 0) else 1
    flops = sum(c["flops"] / (dp * c.get("flops_shards", c["model_shards"]))
                for c in comps.values())
    # weight-like traffic: every device reads its weight shard each step;
    # data-like traffic (KV/cache streams) also divides by the batch shards.
    bytes_ = sum(c["bytes"] / c["model_shards"]
                 + c.get("data_bytes", 0.0) / (dp * c["model_shards"])
                 for c in comps.values())
    return {"flops_per_dev": flops, "bytes_per_dev": bytes_, "dp_shards": dp}


# ---------------------------------------------------------------------------
# Counts taken on the meta device
# ---------------------------------------------------------------------------


def meta_flops(fn, *args) -> dict:
    """{"flops": float, "by_op": {aten op: flops}, "outputs": fn's
    result} of ``fn(*args)`` run once on meta tensors (shapes only) under
    ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        outputs = fn(*args)
    by_op = {str(k): int(v) for k, v in
             counter.get_flop_counts().get("Global", {}).items()}
    return {"flops": float(counter.get_total_flops()), "by_op": by_op,
            "outputs": outputs}


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def tensor_bytes(tree) -> int:
    """Bytes of every tensor of a nested dict / list / tuple (a
    NamedTuple's fields too); other leaves count nothing."""
    return sum(x.numel() * x.element_size() for x in _tensors(tree))


def memory_dict(args, outputs) -> dict:
    """Per-rank bytes: the step's arguments (what the rank holds) and its
    outputs that are not arguments written in place; their sum is the
    peak this accounting sees (no temporaries: torch has no buffer plan
    to read them from)."""
    arg = tensor_bytes(args)
    held = {id(t) for t in _tensors(args)}
    out = sum(t.numel() * t.element_size() for t in _tensors(outputs)
              if id(t) not in held)
    return {"argument_size_in_bytes": arg, "output_size_in_bytes": out,
            "peak_memory_in_bytes": arg + out}


@contextlib.contextmanager
def collective_bytes():
    """Count the port's collectives while the body runs a step on meta
    tensors: yields {"all-gather": bytes, "all-reduce": bytes, "total",
    "counts": {...}} (result bytes per rank, as the JAX package counts
    HLO collectives), filled as the step runs.  The collectives return
    meta tensors of their result's shape and move nothing."""
    from repro_torch.models import attention as attn_mod

    out = {"all-gather": 0, "all-reduce": 0}
    counts = {"all-gather": 0, "all-reduce": 0}

    def gather(x, dim, mesh, axis="model"):
        n = int(mesh.shape[axis])
        shape = list(x.shape)
        shape[dim] *= n
        res = torch.empty(shape, dtype=x.dtype, device=x.device)
        out["all-gather"] += res.numel() * res.element_size()
        counts["all-gather"] += 1
        return res

    def reduce(x, op, group):
        del op, group
        out["all-reduce"] += x.numel() * x.element_size()
        counts["all-reduce"] += 1
        return torch.empty_like(x)

    saved = attn_mod.all_gather_raw, attn_mod.all_reduce
    attn_mod.all_gather_raw, attn_mod.all_reduce = gather, reduce
    try:
        yield out
    finally:
        attn_mod.all_gather_raw, attn_mod.all_reduce = saved
        out["total"] = out["all-gather"] + out["all-reduce"]
        out["counts"] = counts
