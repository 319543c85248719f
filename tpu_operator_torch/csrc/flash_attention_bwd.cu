// Kernel B3: fused attention backward on [BH, S, D] bf16 with a causal
// mask, for Hopper (sm_90a): dQ, dK, dV from q, k, v, the forward's out
// and row statistics (m, l) and the upstream gradient dO. Each bf16
// operand is read or written through its own (bh, row) strides, D
// contiguous.
//
// Replaces no TPU kernel. The JAX package's backward,
// tpu_operator/workloads/flashattention.py `_flash_bwd_rule` (:169-215),
// is jnp, and the port's plain version of it (`flash_bwd_reference`) runs
// every query-key pair of each key chunk through device memory in f32 on
// the CUDA cores. This kernel is added because that backward was the
// training step's whole time.
//
// Bound: operations. Five products of the forward's size (S = Q.K^T
// again, dP = dO.V^T, dV = P^T.dO, dK = dS^T.Q, dQ = dS.K), 2.5 times the
// forward's 4*BH*S*S*D/2 causal flops (perfbench's
// roofline.attention_bwd_flops): at BH=16, S=16384, D=128 causal that is
// 2.75e12 flops, 2.78 ms at the H100 SXM's 989 TFLOP/s bf16, against
// about 0.1 ms for its ~0.4 GB of inputs, outputs and dQ accumulator. Only
// wgmma reaches that rate, so every product is a wgmma with f32
// accumulation, and S, P, dP and dS stay on chip.
//
// Design (FlashAttention-2's backward, arXiv:2307.08691 Alg. 2, with
// FlashAttention-3's Hopper pieces, arXiv:2407.08608 §3.1):
// - three launches on the caller's stream: a preprocess that computes
//   delta = rowsum(dO * O) in f32 and each row's log-sum-exp, in base 2,
//   from the forward's m and l (+inf for a dead row, m <= -1e30/2 or
//   l == 0, so each of its p is exactly 0), and zeroes the f32 dQ
//   accumulator; the main kernel; a postprocess that writes
//   dQ = bf16(acc * scale). The statistics and the accumulator are padded
//   to whole 64-row tiles (lse +inf, delta 0 past Sq);
// - main kernel: one block per (bh, 128-key tile), key tile 0 (which
//   every query tile sees under the causal mask) first; 384 threads:
//   consumer warpgroups 0 and 1 own 64 keys each (wgmma's M), warpgroup 2
//   is the producer; setmaxnreg gives the consumers 240 registers and the
//   producer 24, and the roles split once, with no __syncthreads after;
// - the producer loads K and V once by TMA (B2's 3-D maps, boxes of
//   [128 rows, 64 columns], 128-byte swizzle), then streams tiles of 64
//   query rows (Q, dO, their lse and delta) through a ring of stages (2 at
//   D=128, 4 at D=64) on mbarriers; under the causal mask it starts at the
//   first tile whose last row sees the block's first key;
// - per Q tile each consumer warpgroup computes S^T = K.Q^T and
//   dP^T = V.dO^T (wgmma m64n64k16, both operands K-major from shared
//   memory), then P^T = exp2(S^T * scale * log2e - lse) and
//   dS^T = P^T * (dP^T - delta) in f32; the mask (causal, keys past Sk)
//   zeroes p, and runs only on tiles that cross the diagonal or the
//   ragged end, behind a branch the whole warpgroup takes alike;
// - dV += P^T.dO and dK += dS^T.Q are wgmma RS: the S^T and dP^T
//   accumulators of two adjacent 8-query column groups are the A fragment
//   of one k16 step (B2's trick for P), rounded to bf16, and Q and dO are
//   B MN-major from the ring. P and dS rounded to bf16 as MMA operands are
//   the only new roundings against the f32 plain version;
// - dS^T goes to shared memory as bf16 in the 128-byte swizzle (two
//   buffers, one named barrier a tile between the warpgroups), and
//   dQ_i += dS.K is wgmma m64n64k16 with A (dS) and B (K) both MN-major:
//   warpgroup w takes columns 64w..64w+63 of dQ over all 128 keys (at D=64
//   warpgroup 0 alone). The f32 dQ accumulator is where the blocks of one
//   bh meet: each warp puts its 16 rows (4 KB) in shared memory in the
//   order its lanes hold them (conflict-free 16-byte stores) and one lane
//   adds them into the accumulator, laid out in that order, with one
//   asynchronous bulk reduction (cp.reduce.async.bulk .add.f32), which the
//   warp's next tile waits for only before it stages its own. Each
//   thread's 8-byte reductions (red.global.add.v2.f32) took ~3 of 7 ms at
//   BH=16, S=16384 on an H100 SXM; the postprocess puts the accumulator
//   back in row order;
// - epilogue: dK * scale and dV in bf16, rows past Sk not written. A block
//   that sees no Q tile waits on no barrier and writes zeros;
// - grouped KV heads and a sliding window (the kBand instantiations): one
//   block per (K/V row, 128-key tile) streams the Q tiles of each of its
//   group's query rows in turn through the same ring, so dK and dV sum
//   over the group in registers, with no atomics and no expanded buffer
//   (FlashAttention-2/3's grouped-query backward); dQ keeps its per-row
//   f32 accumulator and bulk reductions. Under a window of W keys a key
//   tile streams only the Q tiles up to the last query that sees its last
//   key, and the mask also runs on tiles that reach past the warpgroup's
//   first key's window. The MHA instantiations keep group 1 and no window
//   at compile time;
// - keys wider than values (flash_bwd<192, 128, true>, MLA's training
//   form: q and k 192 wide, v, out and dO 128; a band instantiation, so
//   any group and window): a warpgroup's dK (64 keys x 192) and dV (64 x
//   128) take 96 + 64 registers, and S^T and dP^T of a 64-query tile 64
//   more, more than the 240 a consumer gets beside a producer warpgroup.
//   So the block has none: 256 threads at 255 registers, and thread 0
//   issues the loads, each stage's next tile once both warpgroups have
//   passed the tile's named barrier. dV += P^T.dO is m64n128k16 RS and
//   dK += dS^T.Q m64n192k16 RS. dQ's three 64-column boxes are shared out
//   evenly: warpgroup w takes box w over the block's 128 keys and box 2
//   over its own 64 keys, each box staged and reduced in turn through one
//   [64, 64] f32 buffer a warpgroup (box 2 gets two reductions). Its grid
//   runs the key tiles fastest, so that the blocks in flight share a few
//   heads' f32 dQ rows and the bulk reductions meet in L2 (at [1, 16384,
//   128] the accumulator is 1.6 GB, and with the heads fastest B3 took
//   131 ms where it takes 64). The preprocess reads out and dO at the
//   value width, the postprocess writes dQ at the key width. Shared
//   memory: K 48 KB, V 32 KB, dS^T 32 KB, two ring stages of Q (24 KB)
//   and dO (16 KB), the dQ staging 32 KB: 226 KB of the 227 a block may
//   have;
// - layouts: the TMA maps of Q, dO, K and V take each tensor's (bh, row)
//   strides as byte strides, and the preprocess (out, dO), the epilogue
//   (dK, dV) and the postprocess (dQ) address through theirs, passed as
//   kernel parameters and read only there. At B = 1 the fold of
//   [1, S, H, D] into [H, S, D] is a view with strides (D, H*D), which B3
//   reads as it is, and dQ, dK and dV written in the same layout reach
//   autograd's leaves as [1, S, H, D] tensors with no copy on either side
//   (FlashAttention-3 reads [B, S, H, D] by strides likewise).
//
// cuTensorMapEncodeTiled is a driver-API function; it is reached through
// the runtime's driver entry point, so the library links no libcuda.
// Launches on the caller's stream and does not synchronise. The C entry
// point returns cudaGetLastError() after each launch (or
// cudaErrorInvalidValue for a size, stride or tensor map it cannot take),
// so a refused launch is reported.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kBlockK = 128;     // keys per block
constexpr int kBlockQ = 64;      // query rows per tile (B3_Q_TILE in Python)
constexpr int kWgKeys = 64;      // keys per consumer warpgroup
constexpr int kKBox = kBlockK * kBoxCols * 2;   // a [128, 64] box of K or V
constexpr int kQBox = kBlockQ * kBoxCols * 2;   // a [64, 64] box of Q or dO
constexpr int kDsTile = kBlockK * kBlockQ * 2;  // dS^T: [128 keys, 64 queries]
constexpr int kStatBytes = kBlockQ * 4;         // a tile's lse or delta
constexpr int kDqTile = kBlockQ * kBoxCols * 4; // f32 dQ [64 rows, 64 columns]
constexpr int kConsumers = 256;  // threads of the two consumer warpgroups
constexpr int kThreads = kConsumers + 128;
// the block starts with 168 registers a thread (65,536 / 384, rounded
// down to 8); the 128 producer threads give up what the 256 consumer
// threads take. An increase the pool cannot grant never returns
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <=
              168 * kThreads, "setmaxnreg would wait forever");
constexpr uint32_t kDsBar = 1;   // named barrier: both halves of dS^T written
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f;  // the forward's NEG_INF

// D the width of q and k, DV that of v, out and dO
template <int D, int DV>
struct Layout {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kVBoxes = DV / kBoxCols;
  static constexpr int kKTile = kBoxes * kKBox;   // K
  static constexpr int kVTile = kVBoxes * kKBox;  // V
  static constexpr int kQTile = kBoxes * kQBox;   // Q
  static constexpr int kDoTile = kVBoxes * kQBox; // dO
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kV = kKTile;               // K at 0
  static constexpr int kDs = kKTile + kVTile;     // two dS^T buffers
  static constexpr int kRing = kDs + 2 * kDsTile; // Q, dO of each stage
  static constexpr int kDq = kRing + kStages * (kQTile + kDoTile);  // dQ staging
  // a [64, 64] f32 box a consumer warpgroup; at split widths each stages
  // its boxes one after another
  static constexpr int kStats = kDq + (D == DV ? kBoxes : 2) * kDqTile;
  static constexpr int kBars = kStats + kStages * 2 * kStatBytes;
  // kv_full, full and empty of each stage; plus the slack that aligns the
  // base to 1024 bytes
  static constexpr int kSmem = 1024 + kBars + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x as one MUFU.EX2; subnormal results flush to 0, 2^-inf is 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// out and dO DV wide, the dQ accumulator D wide
template <int D, int DV>
__global__ void __launch_bounds__(256)
flash_bwd_pre(const bf16* __restrict__ out, const bf16* __restrict__ dout,
              const float* __restrict__ m, const float* __restrict__ l,
              float* __restrict__ lse2, float* __restrict__ delta,
              float* __restrict__ dq_acc, int sq, int sq_pad,
              RowStrides out_st, RowStrides dout_st) {
  constexpr int kLanes = DV / 8;  // threads a row, 8 columns of out each
  constexpr int kAcc = D / kLanes;  // accumulator columns a thread zeroes
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (256 / kLanes) + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int64_t b = row / sq_pad;
  const int r = static_cast<int>(row % sq_pad);
  float4* acc = reinterpret_cast<float4*>(dq_acc + row * D + lane * kAcc);
#pragma unroll
  for (int i = 0; i < kAcc / 4; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float dot = 0.f;
  if (r < sq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        out + b * out_st.bh + r * out_st.row + lane * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * dout_st.bh + r * dout_st.row + lane * 8);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = __bfloat1622float2(o2[i]);
      const float2 gf = __bfloat1622float2(g2[i]);
      dot = fmaf(of.x, gf.x, dot);
      dot = fmaf(of.y, gf.y, dot);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (lane == 0) {
    float lse = INFINITY;
    if (r < sq) {
      const float mr = m[b * sq + r];
      const float lr = l[b * sq + r];
      if (!(mr <= kNegInf / 2) && lr != 0.f) lse = fmaf(mr, kLog2e, log2f(lr));
    }
    lse2[row] = lse;
    delta[row] = r < sq ? dot : 0.f;
  }
}

// kBand: grouped KV heads (the block of K/V row bh_kv streams the tiles of
// query rows bh_kv * group .. bh_kv * group + group - 1 in turn, and dK
// and dV sum over them in registers) and a sliding window of `window`
// keys (0: none). The instantiations without it are the MHA kernel as it
// was, with group 1 and no window
template <int D, int DV, bool kBand>
__global__ void __launch_bounds__(D == DV ? kThreads : kConsumers, 1)
flash_bwd(const __grid_constant__ CUtensorMap q_map,
          const __grid_constant__ CUtensorMap do_map,
          const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map,
          const float* __restrict__ lse2, const float* __restrict__ delta,
          float* __restrict__ dq_acc, bf16* __restrict__ dk,
          bf16* __restrict__ dv, int sq, int sk, int causal, float scale,
          int group, int window, RowStrides dk_st, RowStrides dv_st) {
  using L = Layout<D, DV>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t s_k = base;
  const uint32_t s_v = base + L::kV;
  auto s_ds = [&](int b) { return base + L::kDs + b * kDsTile; };
  auto s_q = [&](int st) {
    return base + L::kRing + st * (L::kQTile + L::kDoTile);
  };
  auto s_do = [&](int st) { return s_q(st) + L::kQTile; };
  auto stat_off = [&](int st) { return L::kStats + st * 2 * kStatBytes; };
  const uint32_t bars = base + L::kBars;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };

  // at split widths the grid runs the key tiles fastest (see launch)
  const int bh_kv = D == DV ? blockIdx.x : blockIdx.y;
  const int heads = kBand ? group : 1;  // query rows a K/V row serves
  const int key0 = (D == DV ? blockIdx.y : blockIdx.x) * kBlockK;
  const int sq_pad = (sq + kBlockQ - 1) / kBlockQ * kBlockQ;
  // under the causal mask the first tile whose last row sees key0; under
  // a window the tiles end at the last query that sees the block's last
  // key
  const int i0 = causal ? key0 / kBlockQ : 0;
  int i1 = sq_pad / kBlockQ;
  if (kBand && window > 0) {
    const int64_t reach =
        (static_cast<int64_t>(key0) + kBlockK + window - 2) / kBlockQ + 1;
    if (reach < i1) i1 = static_cast<int>(reach);
  }
  const int n_iter = i1 > i0 ? i1 - i0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (D == DV && wg == 2) {
    // producer: one thread issues every load
    regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers && n_iter > 0) {
      mbar_arrive_expect_tx(kv_full, L::kKTile + L::kVTile);
      for (int h = 0; h < L::kBoxes; ++h) {
        tma_load_3d(s_k + h * kKBox, &k_map, kv_full, h * kBoxCols, key0,
                    bh_kv);
        if (h < L::kVBoxes)
          tma_load_3d(s_v + h * kKBox, &v_map, kv_full, h * kBoxCols, key0,
                      bh_kv);
      }
      for (int hq = 0; hq < heads; ++hq) {
        const int bh = bh_kv * heads + hq;
        const int64_t stat_row = static_cast<int64_t>(bh) * sq_pad;
        for (int n = 0; n < n_iter; ++n) {
          const int it = hq * n_iter + n;  // the ring's count
          const int st = it % kStages;
          const int row = (i0 + n) * kBlockQ;
          if (it >= kStages) mbar_wait(empty(st), (it / kStages - 1) & 1);
          mbar_arrive_expect_tx(full(st),
                                L::kQTile + L::kDoTile + 2 * kStatBytes);
          for (int h = 0; h < L::kBoxes; ++h) {
            tma_load_3d(s_q(st) + h * kQBox, &q_map, full(st), h * kBoxCols,
                        row, bh);
            if (h < L::kVBoxes)
              tma_load_3d(s_do(st) + h * kQBox, &do_map, full(st),
                          h * kBoxCols, row, bh);
          }
          bulk_load(base + stat_off(st), lse2 + stat_row + row, kStatBytes,
                    full(st));
          bulk_load(base + stat_off(st) + kStatBytes, delta + stat_row + row,
                    kStatBytes, full(st));
        }
      }
    }
  } else if constexpr (D != DV) {
    // the block at split widths, keys 192 wide over values 128: its two
    // warpgroups consume as the branch below, with dK's accumulator D / 2
    // registers beside dV's DV / 2, and dQ's three boxes shared out:
    // warpgroup wg takes box wg over the block's 128 keys and the last box
    // over its own 64, staging one box after the other
    static_assert(D == 192 && DV == 128, "split widths: keys 192, values 128");
    // no producer warpgroup: the block's 256 threads take 255 registers
    // each (240 with one, where the accumulators alone take 160 and S^T
    // and dP^T 64 more), and thread 0 issues every load: K, V and the
    // first stages here, then after each tile's named barrier, when both
    // warpgroups are done with the tile's stage, the tile kStages on into
    // it. A load works out its tile from the block's index, read anew, and
    // the parameters, so that no scalar of its own stays live across the
    // consumers' loop (the loop spilled without that)
    const int total = heads * n_iter;  // the ring's tiles
    auto load_tile = [&](int it) {
      int bx, by;
      asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
      asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(by));
      const int k0 = bx * kBlockK;
      const int first = causal ? k0 / kBlockQ : 0;
      int last = (sq + kBlockQ - 1) / kBlockQ;
      if (kBand && window > 0) {
        const int64_t reach =
            (static_cast<int64_t>(k0) + kBlockK + window - 2) / kBlockQ + 1;
        if (reach < last) last = static_cast<int>(reach);
      }
      const int tiles = last - first;  // > 0: a block with none loads none
      const int hq = it / tiles;
      const int st = it % kStages;
      const int row = (first + it % tiles) * kBlockQ;
      const int bh = by * (kBand ? group : 1) + hq;
      const int64_t stat_row =
          static_cast<int64_t>(bh) * ((sq + kBlockQ - 1) / kBlockQ * kBlockQ);
      mbar_arrive_expect_tx(full(st), L::kQTile + L::kDoTile + 2 * kStatBytes);
      for (int h = 0; h < L::kBoxes; ++h) {
        tma_load_3d(s_q(st) + h * kQBox, &q_map, full(st), h * kBoxCols, row,
                    bh);
        if (h < L::kVBoxes)
          tma_load_3d(s_do(st) + h * kQBox, &do_map, full(st), h * kBoxCols,
                      row, bh);
      }
      bulk_load(base + stat_off(st), lse2 + stat_row + row, kStatBytes,
                full(st));
      bulk_load(base + stat_off(st) + kStatBytes, delta + stat_row + row,
                kStatBytes, full(st));
    };
    if (threadIdx.x == 0 && n_iter > 0) {
      mbar_arrive_expect_tx(kv_full, L::kKTile + L::kVTile);
      for (int h = 0; h < L::kBoxes; ++h) {
        tma_load_3d(s_k + h * kKBox, &k_map, kv_full, h * kBoxCols, key0,
                    bh_kv);
        if (h < L::kVBoxes)
          tma_load_3d(s_v + h * kKBox, &v_map, kv_full, h * kBoxCols, key0,
                      bh_kv);
      }
      for (int it = 0; it < kStages && it < total; ++it) load_tile(it);
    }
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int g = (t % 32) / 4;
    const int qd = t % 4;
    const int krow = wg * kWgKeys + warp * 16 + g;  // and krow + 8, in the block
    const float scale2 = scale * kLog2e;
    // the same for every thread of the warpgroup
    const bool ragged = key0 + wg * kWgKeys + kWgKeys > sk;

    float dk_acc[D / 2];
    float dv_acc[DV / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dv_acc[i] = 0.f;

    if (n_iter > 0) mbar_wait(kv_full, 0);
    for (int hq = 0; hq < heads; ++hq) {
      for (int n = 0; n < n_iter; ++n) {
        const int it = hq * n_iter + n;  // the ring's count
        const int st = it % kStages;
        const int q0 = (i0 + n) * kBlockQ;
        mbar_wait(full(st), (it / kStages) & 1);
        const uint32_t lse_t = base + stat_off(st);
        const uint32_t delta_t = lse_t + kStatBytes;
        const uint32_t ds = s_ds(it & 1);
        // K's base, opaque to the compiler once a tile: the descriptors
        // made from it are made again each tile, not kept live across the
        // loop
        uint32_t kb = s_k;
        asm volatile("" : "+r"(kb));
        float s[32];   // S^T, then P^T
        float dp[32];  // dP^T, then dS^T
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t ck =
              (ks / 4) * kKBox + (ks % 4) * 32 + wg * kWgKeys * 128;
          const uint32_t cq = (ks / 4) * kQBox + (ks % 4) * 32;
          wgmma_ss_m64n64k16<0, 0>(s, sw128_desc(kb + ck, 16, 1024),
                                   sw128_desc(s_q(st) + cq, 16, 1024), ks > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < DV / 16; ++ks) {
          const uint32_t cv =
              (ks / 4) * kKBox + (ks % 4) * 32 + wg * kWgKeys * 128;
          const uint32_t co = (ks / 4) * kQBox + (ks % 4) * 32;
          wgmma_ss_m64n64k16<0, 0>(dp, sw128_desc(kb + L::kV + cv, 16, 1024),
                                   sw128_desc(s_do(st) + co, 16, 1024),
                                   ks > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();  // S^T; dP^T may still run
        fence_operands(s);
        // p = 2^(s * scale * log2e - lse): query 8jj + 2qd + e of the tile
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 lv = ld_shared_f32x2(lse_t + 4 * (8 * jj + 2 * qd));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[4 * jj + 2 * h] = exp2_ftz(fmaf(s[4 * jj + 2 * h], scale2, -lv.x));
            s[4 * jj + 2 * h + 1] =
                exp2_ftz(fmaf(s[4 * jj + 2 * h + 1], scale2, -lv.y));
          }
        }
        if (ragged || (causal && q0 < key0 + wg * kWgKeys + kWgKeys - 1) ||
            (kBand && window > 0 &&
             q0 + kBlockQ - key0 - wg * kWgKeys > window)) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kr = key0 + krow + 8 * h;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = q0 + 8 * jj + 2 * qd + e;
                if (kr >= sk || (causal && c < kr) ||
                    (kBand && window > 0 && c - kr >= window))
                  s[4 * jj + 2 * h + e] = 0.f;
              }
            }
          }
        }
        wgmma_wait<0>();
        fence_operands(dp);
        // dS^T = P^T * (dP^T - delta) in f32, then P^T and dS^T in bf16 as
        // the A fragments of the k16 steps over the tile's 64 queries
        uint32_t pf[4][4], dsf[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int jj = 2 * kk; jj < 2 * kk + 2; ++jj) {
            const float2 dl = ld_shared_f32x2(delta_t + 4 * (8 * jj + 2 * qd));
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              dp[4 * jj + 2 * h] =
                  s[4 * jj + 2 * h] * (dp[4 * jj + 2 * h] - dl.x);
              dp[4 * jj + 2 * h + 1] =
                  s[4 * jj + 2 * h + 1] * (dp[4 * jj + 2 * h + 1] - dl.y);
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
            dsf[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          }
        }
        // dS^T to shared memory in the 128-byte swizzle, as below
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = krow + 8 * h;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            st_shared_s32(ds + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * qd,
                          static_cast<int>(dsf[jj / 2][(jj % 2) * 2 + h]));
        }
        fence_proxy_async();

        fence_operands(dv_acc);
        fence_operands(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_m64n128k16(dv_acc, pf[kk], sw128_desc(
              s_do(st) + kk * 16 * 128, kQBox, 1024));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_m64n192k16(dk_acc, dsf[kk], sw128_desc(
              s_q(st) + kk * 16 * 128, kQBox, 1024));
        wgmma_commit();
        // dQ's accumulator takes these registers
        wgmma_wait<0>();
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        fence_operands(pf);
        fence_operands(dsf);
        // both warpgroups' halves of dS^T are in shared memory, and both
        // are done with the tile's stage
        named_sync(kDsBar, kConsumers);
        if (threadIdx.x == 0 && it + kStages < total) load_tile(it + kStages);
        const int lane = t % 32;
        const uint32_t stage =
            base + L::kDq + wg * kDqTile + warp * (kDqTile / 4);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          // box wg over the block's 128 keys, then the last box over the
          // warpgroup's own 64 keys (the other warpgroup adds the rest)
          const int box = part == 0 ? wg : L::kBoxes - 1;
          const int kk0 = part == 0 ? 0 : wg * (kWgKeys / 16);
          const int steps = part == 0 ? kBlockK / 16 : kWgKeys / 16;
          float dq[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < steps; ++kk)
            wgmma_ss_m64n64k16<1, 1>(
                dq, sw128_desc(ds + (kk0 + kk) * 16 * 128, kQBox, 1024),
                sw128_desc(kb + box * kKBox + (kk0 + kk) * 16 * 128, kKBox,
                           1024),
                kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(dq);
          // each warp stages its 16 rows and adds them with one bulk
          // reduction, as below; its 4 KB are free once the last one has
          // read them
          if (lane == 0) bulk_wait_read<0>();
          __syncwarp();
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            st_shared_f32x4(stage + (jj * 32 + lane) * 16, dq[4 * jj],
                            dq[4 * jj + 1], dq[4 * jj + 2], dq[4 * jj + 3]);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) {
            const int64_t bh = static_cast<int64_t>(blockIdx.y) * heads + hq;
            const int64_t tile =
                (bh * (sq_pad / kBlockQ) + i0 + n) * L::kBoxes + box;
            bulk_reduce_add_f32(dq_acc + tile * (kDqTile / 4) + warp * 1024,
                                stage, kDqTile / 4);
            bulk_commit();
          }
        }
      }
    }

    // the last reductions have landed before the block's shared memory goes
    if (t % 32 == 0) bulk_wait<0>();
    // dK * scale and dV in bf16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = key0 + krow + 8 * h;
      if (kr >= sk) continue;
      bf16* const dk_row = dk + bh_kv * dk_st.bh + kr * dk_st.row + 2 * qd;
      bf16* const dv_row = dv + bh_kv * dv_st.bh + kr * dv_st.row + 2 * qd;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(dk_row + i * 8) =
            pack_bf16(dk_acc[4 * i + 2 * h] * scale,
                      dk_acc[4 * i + 2 * h + 1] * scale);
#pragma unroll
      for (int i = 0; i < DV / 8; ++i)
        *reinterpret_cast<uint32_t*>(dv_row + i * 8) =
            pack_bf16(dv_acc[4 * i + 2 * h], dv_acc[4 * i + 2 * h + 1]);
    }
  } else {
    // consumers: warpgroup wg owns keys key0 + 64wg .. key0 + 64wg + 63
    regs_inc<kConsumerRegs>();
    const int t = threadIdx.x % 128;
    const int warp = t / 32;
    const int g = (t % 32) / 4;
    const int qd = t % 4;
    const int krow = wg * kWgKeys + warp * 16 + g;  // and krow + 8, in the block
    const float scale2 = scale * kLog2e;
    // the same for every thread of the warpgroup
    const bool ragged = key0 + wg * kWgKeys + kWgKeys > sk;

    float dk_acc[D / 2];
    float dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    if (n_iter > 0) mbar_wait(kv_full, 0);
    for (int hq = 0; hq < heads; ++hq) {
      // query row blockIdx.x * heads + hq, read again from blockIdx where
      // it is used (a register held for it spilled at D=128)
      for (int n = 0; n < n_iter; ++n) {
        const int it = hq * n_iter + n;  // the ring's count
        const int st = it % kStages;
        const int q0 = (i0 + n) * kBlockQ;
        mbar_wait(full(st), (it / kStages) & 1);

        float s[32];   // S^T, then P^T
        float dp[32];  // dP^T, then dS^T
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          // k16 step ks: box ks / 4, 32 bytes per step within its rows
          const uint32_t ck = (ks / 4) * kKBox + (ks % 4) * 32 + wg * kWgKeys * 128;
          const uint32_t cq = (ks / 4) * kQBox + (ks % 4) * 32;
          wgmma_ss_m64n64k16<0, 0>(s, sw128_desc(s_k + ck, 16, 1024),
                                   sw128_desc(s_q(st) + cq, 16, 1024), ks > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t ck = (ks / 4) * kKBox + (ks % 4) * 32 + wg * kWgKeys * 128;
          const uint32_t cq = (ks / 4) * kQBox + (ks % 4) * 32;
          wgmma_ss_m64n64k16<0, 0>(dp, sw128_desc(s_v + ck, 16, 1024),
                                   sw128_desc(s_do(st) + cq, 16, 1024), ks > 0);
        }
        wgmma_commit();

        const float* lse_t =
            reinterpret_cast<const float*>(gbase + stat_off(st));
        const float* delta_t = lse_t + kBlockQ;
        wgmma_wait<1>();  // S^T; dP^T may still run
        fence_operands(s);
        // p = 2^(s * scale * log2e - lse): query 8jj + 2qd + e of the tile
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 lv =
              *reinterpret_cast<const float2*>(lse_t + 8 * jj + 2 * qd);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[4 * jj + 2 * h] = exp2_ftz(fmaf(s[4 * jj + 2 * h], scale2, -lv.x));
            s[4 * jj + 2 * h + 1] =
                exp2_ftz(fmaf(s[4 * jj + 2 * h + 1], scale2, -lv.y));
          }
        }
        // only tiles that reach past the warpgroup's first key or past sk
        // (under a window also past its first key's window)
        if (ragged || (causal && q0 < key0 + wg * kWgKeys + kWgKeys - 1) ||
            (kBand && window > 0 &&
             q0 + kBlockQ - key0 - wg * kWgKeys > window)) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int kr = key0 + krow + 8 * h;
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = q0 + 8 * jj + 2 * qd + e;
                if (kr >= sk || (causal && c < kr) ||
                    (kBand && window > 0 && c - kr >= window))
                  s[4 * jj + 2 * h + e] = 0.f;
              }
            }
          }
        }
        wgmma_wait<0>();
        fence_operands(dp);
        // dS^T = P^T * (dP^T - delta) in f32, then P^T and dS^T in bf16 as
        // the A fragments of the k16 steps over the tile's 64 queries
        uint32_t pf[4][4], dsf[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int jj = 2 * kk; jj < 2 * kk + 2; ++jj) {
            const float2 dl =
                *reinterpret_cast<const float2*>(delta_t + 8 * jj + 2 * qd);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              dp[4 * jj + 2 * h] =
                  s[4 * jj + 2 * h] * (dp[4 * jj + 2 * h] - dl.x);
              dp[4 * jj + 2 * h + 1] =
                  s[4 * jj + 2 * h + 1] * (dp[4 * jj + 2 * h + 1] - dl.y);
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
            dsf[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          }
        }
        // dS^T to shared memory, row = key, 64 queries a 128-byte row, in the
        // 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8))
        unsigned char* ds = gbase + L::kDs + (it & 1) * kDsTile;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = krow + 8 * h;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<uint32_t*>(ds + r * 128 + ((jj ^ (r & 7)) << 4) +
                                         4 * qd) = dsf[jj / 2][(jj % 2) * 2 + h];
        }
        fence_proxy_async();

        fence_operands(dv_acc);
        fence_operands(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          // queries 16kk..16kk+15: two 8-row atoms; the next 64 columns of
          // dO (and Q) are the next box
          const uint64_t bdo = sw128_desc(s_do(st) + kk * 16 * 128, kQBox, 1024);
          if constexpr (D == 128) wgmma_rs_m64n128k16(dv_acc, pf[kk], bdo);
          else wgmma_rs_m64n64k16(dv_acc, pf[kk], bdo);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bq = sw128_desc(s_q(st) + kk * 16 * 128, kQBox, 1024);
          if constexpr (D == 128) wgmma_rs_m64n128k16(dk_acc, dsf[kk], bq);
          else wgmma_rs_m64n64k16(dk_acc, dsf[kk], bq);
        }
        wgmma_commit();
        // both warpgroups' halves of dS^T are in shared memory
        named_sync(kDsBar, kConsumers);
        if (wg < L::kBoxes) {
          float dq[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBlockK / 16; ++kk)
            wgmma_ss_m64n64k16<1, 1>(
                dq, sw128_desc(s_ds(it & 1) + kk * 16 * 128, kQBox, 1024),
                sw128_desc(s_k + wg * kKBox + kk * 16 * 128, kKBox, 1024),
                kk > 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(dq);
          fence_operands(dv_acc);
          fence_operands(dk_acc);
          fence_operands(pf);
          fence_operands(dsf);
          mbar_arrive(empty(st));
          // each warp stages its 16 rows, float4 jj of lane x at [jj][x] of
          // its 4 KB, and adds them with one bulk reduction; the warp's 4 KB
          // is free once its last reduction has read them
          const int lane = t % 32;
          if (lane == 0) bulk_wait_read<0>();
          __syncwarp();
          const uint32_t stage = L::kDq + wg * kDqTile + warp * (kDqTile / 4);
          float4* mine = reinterpret_cast<float4*>(gbase + stage) + lane;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            mine[jj * 32] = make_float4(dq[4 * jj], dq[4 * jj + 1],
                                        dq[4 * jj + 2], dq[4 * jj + 3]);
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) {
            const int64_t bh = static_cast<int64_t>(blockIdx.x) * heads + hq;
            const int64_t tile =
                (bh * (sq_pad / kBlockQ) + i0 + n) * L::kBoxes + wg;
            bulk_reduce_add_f32(dq_acc + tile * (kDqTile / 4) + warp * 1024,
                                base + stage, kDqTile / 4);
            bulk_commit();
          }
        } else {
          wgmma_wait<0>();
          fence_operands(dv_acc);
          fence_operands(dk_acc);
          fence_operands(pf);
          fence_operands(dsf);
          mbar_arrive(empty(st));
        }
      }
    }

    // the last reductions have landed before the block's shared memory goes
    if (wg < L::kBoxes && t % 32 == 0) bulk_wait<0>();
    // dK * scale and dV in bf16
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = key0 + krow + 8 * h;
      if (kr >= sk) continue;
      bf16* const dk_row = dk + bh_kv * dk_st.bh + kr * dk_st.row + 2 * qd;
      bf16* const dv_row = dv + bh_kv * dv_st.bh + kr * dv_st.row + 2 * qd;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(dk_row + i * 8) =
            pack_bf16(dk_acc[4 * i + 2 * h] * scale,
                      dk_acc[4 * i + 2 * h + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv_row + i * 8) =
            pack_bf16(dv_acc[4 * i + 2 * h], dv_acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

// dq = bf16(acc * scale), 8 columns a thread. The accumulator holds, for
// each (bh, 64-row tile, 64-column box), 4096 f32 in the order the main
// kernel's warps stage them: float4 jj of lane x of warp w at
// [w][jj][x], with w = r / 16, x = 4 * (r % 8) + c % 8 / 2, jj = c / 8
// and entry 2 * (r / 8 % 2) + c % 2 for row r and column c of the tile;
// rows past sq are skipped, and dq is written through its strides
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_post(const float* __restrict__ dq_acc, bf16* __restrict__ dq,
               int64_t rows, int sq, int sq_pad, float scale,
               RowStrides dq_st) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= rows * (D / 8)) return;
  const int64_t row = idx / (D / 8);
  const int cb = static_cast<int>(idx % (D / 8));  // columns 8cb..8cb+7
  const int r = static_cast<int>(row % sq);
  const int rr = r % kBlockQ;
  const float* tile =
      dq_acc + (((row / sq) * (sq_pad / kBlockQ) + r / kBlockQ) * (D / kBoxCols) +
                cb / 8) * (kDqTile / 4);
  const float* src = tile + ((rr / 16) * 256 + (cb % 8) * 32 + (rr % 8) * 4) * 4 +
                     2 * (rr / 8 % 2);
  uint32_t o[4];
#pragma unroll
  for (int qd = 0; qd < 4; ++qd) {
    const float2 x = *reinterpret_cast<const float2*>(src + 4 * qd);
    o[qd] = pack_bf16(x.x * scale, x.y * scale);
  }
  *reinterpret_cast<uint4*>(dq + (row / sq) * dq_st.bh + r * dq_st.row +
                            cb * 8) = make_uint4(o[0], o[1], o[2], o[3]);
}

// the operands' strides, in the C entry point's order
enum { kStQ, kStK, kStV, kStOut, kStDout, kStDq, kStDk, kStDv, kOperands };

template <int D, int DV, bool kBand>
int launch(int64_t bh, int64_t sq, int64_t sk, cudaStream_t s, const void* q,
           const void* k, const void* v, const bf16* out, const bf16* dout,
           const float* m, const float* l, bf16* dq, bf16* dk, bf16* dv,
           float* stats, float* dq_acc, int causal, float scale, int group,
           int window, const RowStrides* st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map, do_map, k_map, v_map;
  if (!encode_map(fn, &q_map, q, bh, sq, D, st[kStQ], kBlockQ) ||
      !encode_map(fn, &do_map, dout, bh, sq, DV, st[kStDout], kBlockQ) ||
      !encode_map(fn, &k_map, k, bh / group, sk, D, st[kStK], kBlockK) ||
      !encode_map(fn, &v_map, v, bh / group, sk, DV, st[kStV], kBlockK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t sq_pad = (sq + kBlockQ - 1) / kBlockQ * kBlockQ;
  float* lse2 = stats;
  float* delta = stats + bh * sq_pad;

  // bh * sq_pad is a multiple of 64, so every block is whole
  flash_bwd_pre<D, DV><<<static_cast<unsigned>(bh * sq_pad /
                                                 (256 / (DV / 8))),
                         256, 0, s>>>(out, dout, m, l, lse2, delta, dq_acc,
                                  static_cast<int>(sq),
                                  static_cast<int>(sq_pad), st[kStOut],
                                  st[kStDout]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr int kSmem = Layout<D, DV>::kSmem;
  static_assert(kSmem <= 232448, "B3's shared memory exceeds a block's");
  err = cudaFuncSetAttribute(flash_bwd<D, DV, kBand>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block per (K/V row, key tile); at split widths the key tiles
  // run fastest, so the blocks in flight share a few rows' f32 dQ
  // accumulators, which then stay in L2: at 128 heads of 192 the
  // accumulator is 1.6 GB, and with the rows fastest every block's bulk
  // reductions went to device memory (73 of 128 ms at [1, 16384, 128])
  const unsigned rows = static_cast<unsigned>(bh / group);
  const unsigned tiles = static_cast<unsigned>((sk + kBlockK - 1) / kBlockK);
  if (D != DV && rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = D == DV ? dim3(rows, tiles) : dim3(tiles, rows);
  flash_bwd<D, DV, kBand><<<grid, D == DV ? kThreads : kConsumers, kSmem,
                            s>>>(
      q_map, do_map, k_map, v_map, lse2, delta, dq_acc, dk, dv,
      static_cast<int>(sq), static_cast<int>(sk), causal, scale, group,
      window, st[kStDk], st[kStDv]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t n8 = bh * sq * (D / 8);
  flash_bwd_post<D><<<static_cast<unsigned>((n8 + 255) / 256), 256, 0, s>>>(
      dq_acc, dq, bh * sq, static_cast<int>(sq), static_cast<int>(sq_pad),
      scale, st[kStDq]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq, dk, dv = the attention backward on `stream`: q, out, dout
// [bh, sq, d], k, v [bh / group, sk, d] bf16, m, l [bh, sq] f32 (the
// forward's, contiguous); dq, dk, dv bf16 like q, k, v, dk and dv summed
// over each K/V row's group of query rows; window > 0 (causal only) as the
// forward's. `strides` holds, for q, k, v, out, dout, dq, dk and dv in that
// order, the (bh, row) strides in elements, each a multiple of 8 (16
// bytes): d is contiguous in every operand, and every bf16 base is
// 16-byte aligned. Workspace: stats f32 [2, bh, sq_pad] and dq_acc f32
// [bh, sq_pad, d], contiguous, with sq_pad = sq rounded up to a multiple
// of 64. (d, dv) is (64, 64), (128, 128) or (192, 128): values as wide as
// keys, or keys 192 wide over values 128 (out, dout and dv at the value
// width, dq and dk at the key width). B3 has no sink gradient, so `sinks`
// must be null. `scale` multiplies the scores (the caller's softmax
// scale). Every tensor and `stream` are on CUDA device `device`. Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* m, const void* l, void* dq, void* dk,
    void* dv, void* stats, void* dq_acc, int64_t bh, int64_t sq, int64_t sk,
    int64_t d, int64_t dv_width, int causal, float scale, int64_t group,
    int64_t window, const void* sinks, const int64_t* strides, int device,
    void* stream) {
  RowStrides st[kOperands];
  const void* bases[kOperands] = {q, k, v, out, dout, dq, dk, dv};
  if (sinks != nullptr || !read_strides(strides, bases, kOperands, st))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 2147483647 ||
      sq > 2147483647 - kBlockQ || (sk + kBlockK - 1) / kBlockK > 65535 ||
      bh * ((sq + kBlockQ - 1) / kBlockQ) * kBlockQ / 16 > 2147483647 ||
      bh * sq * d / 8 / 256 > 2147483647 ||
      !group_window_ok(bh, group, window, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = bind_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* po = static_cast<const bf16*>(out);
  const bf16* pg = static_cast<const bf16*>(dout);
  const float* pm = static_cast<const float*>(m);
  const float* pl = static_cast<const float*>(l);
  bf16* pdq = static_cast<bf16*>(dq);
  bf16* pdk = static_cast<bf16*>(dk);
  bf16* pdv = static_cast<bf16*>(dv);
  float* pst = static_cast<float*>(stats);
  float* pacc = static_cast<float*>(dq_acc);
  return dispatch(d, dv_width, group, window, false,
                  [&](auto dim, auto vdim, auto band, int g, int w) {
    return launch<decltype(dim)::value, decltype(vdim)::value,
                  decltype(band)::value>(
        bh, sq, sk, s, q, k, v, po, pg, pm, pl, pdq, pdk, pdv, pst, pacc,
        causal, scale, g, w, st);
  });
}
