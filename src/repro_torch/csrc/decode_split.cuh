// Flash-decode of one query token per (sequence, kv head) with the rows
// split over the CTAs of one thread-block cluster, designed for Hopper.
// Used by the paged decode kernels (paged_attention.cu: rows behind a
// block table).
//
// A cluster of n_split CTAs (at most 8, the portable cluster size) serves
// one (sequence, kv head) and its whole GQA group; CTA rank s takes the
// contiguous logical row range [c0, c1) its kernel gives it.  Inside a
// CTA the rows are cut into WARPS contiguous runs, one per warp, and a
// warp takes RPS rows per step: LPR = HD / VEC lanes per row, each lane
// holding VEC consecutive dimensions (one 16-byte load of K and of V).
// Every lane keeps its slice of the group's query heads in registers and
// its own online-softmax state (m, l, acc) per head, so a K/V row read
// once serves all G heads; a dot product is reduced with xor shuffles
// within the row's lanes.  The heads run in passes of GP = 4 (the group
// of every model the paged route serves: G = 2, 3 or 4); a larger G
// takes more passes over the rows, a smaller one scores padded heads.
//
// Latency, not bytes, bounds the call (a few MB at most), so the row loop
// keeps memory requests in flight and never waits on a barrier: each lane
// resolves one row of a 32-row batch (the row map's first load, e.g. the
// block table, two batches ahead; its validity load, e.g. the mask byte,
// one batch ahead), the row ids reach the row's lanes by shuffle, and
// each lane copies its K/V vectors with cp.async into its own 16-byte
// slots of a shared-memory ring of NST (up to 8) steps, refilled a chunk
// of CH (2 or 4) steps at a time, so no other thread waits on them.  A
// row's copy needs only its place, so it starts beside its validity
// load, not after it: two dependent round trips (table, then mask and K/V
// together) before the first row is scored.  Rows with no storage (null
// blocks) cost their validity load only; masked rows of allocated blocks
// are read and zeroed.  A chunk's CH steps are scored together
// (independent dot products and shuffles), then the state takes one
// running max and one rescale per head.
//
// Merges, all in a fixed order (deterministic, no atomics, no workspace
// in device memory, no second launch): the row slots of a warp by xor
// shuffles; then every warp pushes its (m, l) per head to every CTA of the
// cluster and its acc slice of each CTA's share of the outputs into that
// CTA's shared memory (distributed shared memory stores), one cluster
// barrier, and each CTA merges the n_split x WARPS partials of its share
// in (rank, warp) order from its own shared memory and writes them.  A
// CTA or warp with no live row contributes m = NEG_INF, l = 0; a
// (sequence, kv head) with no live row writes exact zeros (common.cuh).
//
// With MASSES the rows' scaled logits per query head (-inf where dead)
// are kept while the rows stream, in shared memory for the first LCAP
// steps of a warp and in the masses beyond, and after the
// merge the warp writes exp(s - m) / max(l, 1e-30) with the final (m, l)
// into the masses (coalesced from shared memory): K is read once.  The
// global stores of out and the masses follow the cluster barrier, so it
// does not wait for them.  The flag adds those stores and that rescale
// and nothing else, and the attention arithmetic uses explicitly rounded
// intrinsics (no contraction left to the compiler), so `out` is bitwise
// the MASSES = false result at the same split.  Logits are kept in base 2
// (scale * log2(e) folded into the query scale) and exponentials are
// exp2f.
#pragma once

#include "common.cuh"

namespace decode_split {

constexpr int WARPS = 4;  // warps per CTA
constexpr int THREADS = 32 * WARPS;
constexpr int GP = 4;  // query heads per pass
constexpr int MAX_SPLITS = 8;  // CTAs per cluster (the portable limit)
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// This CTA's rank in its cluster, and the cluster's size.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

// Every thread of every CTA of the cluster: shared-memory writes before it
// (the cluster's too) are visible to reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The same barrier in two halves, ordering nothing: after the wait every
// CTA of the cluster has started, so its shared memory may be written.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address of `p` (this CTA's shared memory) in CTA `rank` of the
// cluster, as a generic pointer (distributed shared memory).
template <typename P>
__device__ __forceinline__ P* map_rank(P* p, int rank) {
  uint64_t out;
  asm("mapa.u64 %0, %1, %2;\n"
      : "=l"(out)
      : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<P*>(out);
}

__device__ __forceinline__ void widen(const uint4& raw, float (&x)[4]) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}

// 8 bfloat16 -> float (exact: a bf16 is the top half of a float)
__device__ __forceinline__ void widen(const uint4& raw, float (&x)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Merge this lane's state (m, l, acc) with a partner lane's (mb, lb,
// accb), the lower lane's state first, so both lanes end with the same
// bits.
template <int VEC>
__device__ __forceinline__ void merge(bool first, float& m, float& l,
                                      float (&acc)[VEC], float mb, float lb,
                                      const float (&accb)[VEC]) {
  const float mx = first ? m : mb, my = first ? mb : m;
  const float lx = first ? l : lb, ly = first ? lb : l;
  const float mn = fmaxf(mx, my);
  const float cx = exp2f(__fsub_rn(mx, mn)), cy = exp2f(__fsub_rn(my, mn));
  l = __fmaf_rn(lx, cx, __fmul_rn(ly, cy));
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float ax = first ? acc[e] : accb[e], ay = first ? accb[e] : acc[e];
    acc[e] = __fmaf_rn(ax, cx, __fmul_rn(ay, cy));
  }
  m = mn;
}

// Shapes and the dynamic shared memory of one instantiation (host and
// device).
template <typename T, int HD, bool MASSES>
struct Shape {
  static constexpr int VEC = 16 / sizeof(T);  // values per 16-byte load
  static constexpr int LPR = HD / VEC;        // lanes per row
  static constexpr int RPS = 32 / LPR;        // rows per warp step
  static constexpr int SPB = 32 / RPS;        // steps per 32-row batch
  // ring stages, at most one batch of steps (a copy then starts at most
  // NST + CH - 1 steps ahead, within the next batch of row ids), and
  // the steps scored together, at least two chunks to the ring
  static constexpr int NST = SPB < 8 ? SPB : 8;
  static constexpr int CH = NST < 8 ? 2 : 4;
  // with MASSES, the logits of a warp's first LCAP steps wait in shared
  // memory for the final (m, l); later steps' wait in the masses
  static constexpr int LCAP = 16;
  static constexpr int PARTS = MAX_SPLITS * WARPS;  // partials per output
  // a rank's share of the G x HD outputs is a multiple of VEC, so n_split
  // shares hold at most GP * HD + MAX_SPLITS * VEC values
  static constexpr int ACC = WARPS * (GP * HD + MAX_SPLITS * VEC);
  // byte offsets: the K/V ring, received partials (acc, m, l), the merge
  // weights, final (m, 1 / l), the logits
  static constexpr int RING_B = WARPS * NST * 64 * 16;
  static constexpr int ACC_B = RING_B;
  static constexpr int M_B = ACC_B + ACC * 4;
  static constexpr int L_B = M_B + PARTS * GP * 4;
  static constexpr int W_B = L_B + PARTS * GP * 4;
  static constexpr int FIN_B = W_B + PARTS * GP * 4;
  static constexpr int LG_B = FIN_B + 2 * GP * 4;
  static constexpr int BYTES =
      LG_B + (MASSES ? WARPS * LCAP * RPS * GP * 4 : 0);
  static_assert(LPR <= 32 && CH >= 2 && NST % CH == 0 && SPB % CH == 0 &&
                    PARTS % 32 == 0,
                "shape");
};

// Row maps resolve logical row c in two dependent loads:
//   int where(int c)      -> row r of the K/V arrays (rows, KV, HD);
//   bool stored(int r)    -> whether row r holds data (false: skip its
//                            K/V read; the row must then be dead);
//   int2 probe(int r)     -> the raw words that decide r's validity;
//   bool alive(int2 w)    -> whether the row may be attended.
//
// q points at the group's first query head (G x HD values), out at the
// group's first output head, and with MASSES `mass` at the group's first
// query head's row of n_rows floats (G rows back to back).  [c0, c1) is
// this CTA's range of logical rows.  Launch THREADS threads per CTA in
// clusters of (n_split, 1, 1) with Shape<T, HD, MASSES>::BYTES of
// dynamic shared memory at `smem`; every CTA of a cluster must pass the
// same q, out, mass and G.
template <typename T, int HD, bool MASSES, typename Rows>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       T* __restrict__ out,
                                       float* __restrict__ mass, int KV,
                                       int kvh, int G, int n_rows, int c0,
                                       int c1, const Rows& rows, float scale,
                                       unsigned char* smem) {
  using S = Shape<T, HD, MASSES>;
  constexpr int VEC = S::VEC, LPR = S::LPR, RPS = S::RPS, SPB = S::SPB;
  constexpr int CH = S::CH, NST = S::NST, LCAP = S::LCAP, PARTS = S::PARTS;
  float* r_acc = reinterpret_cast<float*>(smem + S::ACC_B);
  float* r_m = reinterpret_cast<float*>(smem + S::M_B);  // [part][GP]
  float* r_l = reinterpret_cast<float*>(smem + S::L_B);
  float* s_w = reinterpret_cast<float*>(smem + S::W_B);  // [part][GP]
  float* s_fm = reinterpret_cast<float*>(smem + S::FIN_B);
  float* s_finv = s_fm + GP;
  float* s_lg = reinterpret_cast<float*>(smem + S::LG_B);

  cluster_arrive();  // this CTA has started (see cluster_wait below)
  const int n_split = cluster_size(), rank = cluster_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slot = lane / LPR, sub = lane % LPR, d0 = sub * VEC;
  const float qscale = scale * LOG2E;
  // this lane's K slot of stage i is ring[i * 64], its V slot ring[i * 64
  // + 32]
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * NST * 64 + lane;

  // this warp's run of rows, a whole number of steps
  int per = (c1 - c0 + WARPS - 1) / WARPS;
  per = (per + RPS - 1) / RPS * RPS;
  const int w0 = min(c1, c0 + warp * per), w1 = min(c1, w0 + per);
  const int steps = (w1 - w0 + RPS - 1) / RPS;
  auto where = [&](int c) { return c < w1 ? rows.where(c) : -1; };
  auto probe = [&](int r) {
    return r >= 0 ? rows.probe(r) : make_int2(0, 0);
  };
  auto resolve = [&](int r, int2 w) {
    return r >= 0 && rows.alive(w) ? r : -1;
  };

  bool started = false;  // cluster_wait done
  for (int h0 = 0; h0 < G; h0 += GP) {
    const int ng = min(GP, G - h0);
    float qf[GP][VEC], m[GP], l[GP], acc[GP][VEC];
#pragma unroll
    for (int h = 0; h < GP; ++h) {
      if (h < ng) {  // padded heads score zeros and are never stored
        widen(*reinterpret_cast<const uint4*>(q + (h0 + h) * HD + d0),
              qf[h]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[h][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qf[h][e] = __fmul_rn(qf[h][e], qscale);
        acc[h][e] = 0.f;
      }
      m[h] = NEG_INF;
      l[h] = 0.f;
    }

    // row pipeline, this lane's row of each 32-row batch: batch j's row
    // (a_cur), validity words (p_cur) and resolved id (rid); batch j + 1's
    // row and validity words (a_nxt, p_nxt, loads in flight); batch j + 2's
    // row (a_nn, in flight)
    int a_cur = where(w0 + lane), a_nxt = where(w0 + 32 + lane);
    int a_nn = where(w0 + 64 + lane);
    int2 p_cur = probe(a_cur), p_nxt = probe(a_nxt);
    int batch = 0;

    // copy step t's K/V vectors of this lane into stage t % NST as one
    // group: a row's copy needs only its place (the block table), not its
    // validity, so it flies beside the validity loads; rows with no
    // storage (past the run, or a null block) are not read.  t lies in
    // batch `batch` or the next one.
    auto fetch = [&](int t) {
      const int mine = t / SPB == batch ? a_cur : a_nxt;
      const int r = __shfl_sync(FULL, mine, (t % SPB) * RPS + slot);
      if (t < steps && r >= 0 && rows.stored(r)) {
        const size_t o = ((size_t)r * KV + kvh) * HD + d0;
        uint4* st = ring + (t % NST) * 64;
        cp_async16(st, k + o);
        cp_async16(st + 32, v + o);
      }
      cp_async_commit();
    };

#pragma unroll
    for (int t = 0; t < NST; ++t) fetch(t);
    int rid = resolve(a_cur, p_cur);
    for (int t0 = 0; t0 < steps; t0 += CH) {
      if (t0 > 0 && t0 % SPB == 0) {  // the next batch: rotate the rows
        ++batch;
        a_cur = a_nxt;
        p_cur = p_nxt;
        rid = resolve(a_cur, p_cur);
        a_nxt = a_nn;
        p_nxt = probe(a_nxt);
        a_nn = where(w0 + (batch + 2) * 32 + lane);
      }
      cp_async_wait<NST - CH>();  // this chunk's groups have landed
      // the chunk's logits; a dead row's (or a stale slot's) is -inf
      float sc[CH][GP];
      bool ok[CH];
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int t = t0 + u;
        ok[u] = __shfl_sync(FULL, rid, (t % SPB) * RPS + slot) >= 0;
        float kf[VEC];
        widen(ring[(t % NST) * 64], kf);
#pragma unroll
        for (int h = 0; h < GP; ++h) {
          sc[u][h] = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            sc[u][h] = __fmaf_rn(qf[h][e], kf[e], sc[u][h]);
        }
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < CH; ++u) {
#pragma unroll
          for (int h = 0; h < GP; ++h)
            sc[u][h] =
                __fadd_rn(sc[u][h], __shfl_xor_sync(FULL, sc[u][h], o));
        }
      }
#pragma unroll
      for (int u = 0; u < CH; ++u) {
#pragma unroll
        for (int h = 0; h < GP; ++h)
          sc[u][h] = ok[u] ? sc[u][h] : __int_as_float(0xff800000);
      }
      if (MASSES) {  // one lane per (row, head) keeps the logit
        if (t0 < LCAP) {  // the row's first lane, all heads at once
          if (sub == 0) {
#pragma unroll
            for (int u = 0; u < CH; ++u)
              *reinterpret_cast<float4*>(
                  s_lg + ((warp * LCAP + t0 + u) * RPS + slot) * GP) =
                  make_float4(sc[u][0], sc[u][1], sc[u][2], sc[u][3]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            const int c = w0 + (t0 + u) * RPS + slot;
#pragma unroll
            for (int h = 0; h < GP; ++h)
              if (h < ng && sub == h % LPR && c < w1)
                mass[(size_t)(h0 + h) * n_rows + c] = sc[u][h];
          }
        }
      }
      // one running max and one rescale per head for the chunk; the
      // logits become their weights p in place
#pragma unroll
      for (int h = 0; h < GP; ++h) {
        float mn = m[h];
#pragma unroll
        for (int u = 0; u < CH; ++u) mn = fmaxf(mn, sc[u][h]);
        const float corr = exp2f(__fsub_rn(m[h], mn));
        l[h] = __fmul_rn(l[h], corr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][e] = __fmul_rn(acc[h][e], corr);
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          sc[u][h] = exp2f(__fsub_rn(sc[u][h], mn));
          l[h] = __fadd_rn(l[h], sc[u][h]);
        }
        m[h] = mn;
      }
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        float vf[VEC];
        widen(ring[((t0 + u) % NST) * 64 + 32], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e)  // a dead row's V may hold anything
          vf[e] = ok[u] ? vf[e] : 0.f;
#pragma unroll
        for (int h = 0; h < GP; ++h) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[h][e] = __fmaf_rn(sc[u][h], vf[e], acc[h][e]);
        }
      }
#pragma unroll
      for (int u = 0; u < CH; ++u) fetch(t0 + NST + u);  // refill the chunk
    }
    cp_async_wait<0>();

    // the row slots of the warp (lanes LPR apart): every lane ends with the
    // warp's state
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
      for (int h = 0; h < GP; ++h) {
        float accb[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          accb[e] = __shfl_xor_sync(FULL, acc[h][e], o);
        const float mb = __shfl_xor_sync(FULL, m[h], o);
        const float lb = __shfl_xor_sync(FULL, l[h], o);
        merge((lane & o) == 0, m[h], l[h], acc[h], mb, lb, accb);
      }
    }

    // push this warp's partial: (m, l) of every head to every rank, acc
    // to the rank whose share holds it
    if (!started) {
      cluster_wait();
      started = true;
    }
    const int part = rank * WARPS + warp;
    const int total = ng * HD;
    const int share = ((total + n_split - 1) / n_split + VEC - 1) / VEC * VEC;
    if (lane < n_split) {
#pragma unroll
      for (int h = 0; h < GP; ++h) {
        *map_rank(&r_m[part * GP + h], lane) = m[h];
        *map_rank(&r_l[part * GP + h], lane) = l[h];
      }
    }
    if (slot == 0) {
#pragma unroll
      for (int h = 0; h < GP; ++h) {
        const int i = h * HD + d0;  // this lane's first output
        if (h < ng) {
          const int dst = i / share;
          float* to = map_rank(&r_acc[part * share + i - dst * share], dst);
#pragma unroll
          for (int e = 0; e < VEC; e += 4)
            *reinterpret_cast<float4*>(to + e) = make_float4(
                acc[h][e], acc[h][e + 1], acc[h][e + 2], acc[h][e + 3]);
        }
      }
    }
    cluster_sync();

    // this CTA's share of the outputs: the n_split x WARPS partials in
    // (rank, warp) order.  First each head's final (m, 1 / l) and the
    // partials' weights, a warp per head and a lane per partial.
    const int parts = n_split * WARPS;  // lane j takes partials j, j + 32
    for (int h = warp; h < ng; h += WARPS) {
      float mj[PARTS / 32], mf = NEG_INF, lf = 0.f;
#pragma unroll
      for (int x = 0; x < PARTS / 32; ++x) {
        const int q2 = lane + 32 * x;
        mj[x] = q2 < parts ? r_m[q2 * GP + h] : NEG_INF;
        mf = fmaxf(mf, mj[x]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mf = fmaxf(mf, __shfl_xor_sync(FULL, mf, o));
#pragma unroll
      for (int x = 0; x < PARTS / 32; ++x) {
        const int q2 = lane + 32 * x;
        if (q2 < parts) {
          const float wt = exp2f(__fsub_rn(mj[x], mf));
          s_w[q2 * GP + h] = wt;
          lf = __fmaf_rn(r_l[q2 * GP + h], wt, lf);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        lf = __fadd_rn(lf, __shfl_xor_sync(FULL, lf, o));
      if (lane == 0) {
        s_fm[h] = mf;
        s_finv[h] = 1.f / fmaxf(lf, L_FLOOR);
      }
    }
    __syncthreads();
    // then each output, tpe threads summing a strided subset of the
    // partials and a shuffle sum of theirs
    const int e0 = rank * share, n_e = max(0, min(total, e0 + share) - e0);
    int tpe = 1;
    while (tpe < 32 && n_e * tpe * 2 <= THREADS) tpe *= 2;
    const int j = tid % tpe, rounds = (n_e * tpe + THREADS - 1) / THREADS;
    for (int it = 0; it < rounds; ++it) {
      const int idx = it * (THREADS / tpe) + tid / tpe;
      const int h = min(idx + e0, total - 1) / HD;
      float a = 0.f;
      if (idx < n_e) {
#pragma unroll 8
        for (int q2 = j; q2 < parts; q2 += tpe)
          a = __fmaf_rn(r_acc[q2 * share + idx], s_w[q2 * GP + h], a);
      }
      for (int o = 1; o < tpe; o <<= 1)
        a = __fadd_rn(a, __shfl_xor_sync(FULL, a, o));
      if (idx < n_e && j == 0)
        out[h0 * HD + e0 + idx] = from_f32<T>(__fmul_rn(a, s_finv[h]));
    }
    if (MASSES) {
      // exp2(s - m) / l of the rows this warp scored (exp2(-inf - m) is
      // exactly 0, so dead rows and empty heads stay zero): the first
      // LCAP steps' from shared memory, a warp-wide coalesced run per
      // head; later steps' rescaled in place by the lanes that stored them
      const int n_lg = min(w1 - w0, LCAP * RPS);
      for (int h = 0; h < ng; ++h) {
        for (int i = lane; i < n_lg; i += 32)
          mass[(size_t)(h0 + h) * n_rows + w0 + i] =
              exp2f(s_lg[((warp * LCAP + i / RPS) * RPS + i % RPS) * GP + h] -
                    s_fm[h]) * s_finv[h];
      }
      for (int t = LCAP; t < steps; ++t) {
        const int c = w0 + t * RPS + slot;
#pragma unroll
        for (int h = 0; h < GP; ++h) {
          if (h < ng && sub == h % LPR && c < w1) {
            float* pm = mass + (size_t)(h0 + h) * n_rows + c;
            *pm = exp2f(*pm - s_fm[h]) * s_finv[h];
          }
        }
      }
    }
    // another pass pushes into this CTA's buffers only after every CTA is
    // done reading them
    if (h0 + GP < G) cluster_sync();
  }
}

}  // namespace decode_split
