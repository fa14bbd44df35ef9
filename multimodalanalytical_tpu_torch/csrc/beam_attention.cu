// Beam-decode attention kernels for Hopper (sm_90a): lazy-ancestry
// self-attention, with the in-place KV-cache append (update mode) or over a
// cache that already holds this step's rows (read-only mode), and beam
// cross-attention against the beam-invariant encoder K/V.
//
// Replaces multimodalanalytical_tpu/ops/beam_attention.py
// beam_select_attention_update (Pallas _kernel_upd / _kernel_upd_q8),
// beam_select_attention (Pallas _kernel / _kernel_q8; the same kernel
// instantiated with kUpdate = false) and beam_cross_attention (Pallas
// _cross_kernel). They replace this file's first kernels, which ran one
// warp per beam over its keys: two passes per beam (the second recomputed
// every logit and read the key rows again), a value loop that broadcast one
// key at a time, and every selected row read once per beam that selects it.
//
// Select attention is bound by bytes on the H100: a decode step reads the
// ancestor rows of every beam from the slot-flattened cache and does ~2
// flops per byte, far below the ~295 flop/byte where the tensor cores would
// become the limit. The least it can move is each *distinct* selected row
// once, and that is what block (b, h) reads: it builds a bitmask of the
// slots that some beam's ancestry names at each time, numbers those rows
// (prefix sums of the masks), and stages exactly them, head slice and int8
// scale, compacted, into shared memory with cp.async, a chunk of times per
// tile, through a 2-stage ring: one tile loads while the previous one
// computes. The K rows of all chunks stream first, then the V rows; the
// first V tile loads while the softmax runs. Every logit is computed once,
// from shared memory, one (beam, time) pair per thread (eight partial sums
// per dot), into a K x (pos + 1) fp32 buffer; the exact softmax per beam
// row follows (max, sum, normalise); each V tile first tabulates its (beam,
// time) weights (the probability times the value row's int8 scale, rounded
// to bf16) and row offsets, then threads owning 8 output channels of a beam
// (and a share of the times when there are fewer such groups than threads)
// accumulate in fp32. The prologue (queries, ancestry and this step's fresh
// rows) is one round of asynchronous copies. int8 rows become floats by a
// byte permute and a subtraction (common.cuh load8), not the quarter-rate
// conversion unit.
//
// In update mode the block also appends head h's slice of this step's K/V
// rows at flat rows pos * K + n, in place: no other block touches (b, h),
// so the append has no race. With an int8 cache it takes the fresh rows
// un-quantized (bf16, or fp32 in fp32 models) and quantizes them itself
// with quantize_kv_heads' arithmetic: fp32 absmax per (row, head),
// clamp_min 1e-8, IEEE division by 127, rint(x / scale) clamped to +-127
// (the build has no --use_fast_math, so '/' is the IEEE division). Those
// rows are read from shared memory, never from the cache being written.
//
// The step index `pos` is read from device memory at the kernel's start, as
// the Pallas kernel takes it by scalar prefetch, so that one captured CUDA
// graph of a decode step serves every step of a stage: the launcher sizes
// the shared-memory plan and the grid from the stage length L (the
// ancestry slice's time axis), never from pos, and the kernel bounds every
// per-time loop, mask and table by pos + 1 inside that plan. The tile of
// times is min(pos + 1, the plan's), as a plan sized for pos + 1 would
// take, so results at each pos are those of a launch planned for it. A pos
// outside [0, L) writes NaN to the block's output and nothing else.
//
// The kernel takes any stage length up to 65536 (time, slot) rows (its
// staged-row tables are 16-bit). The per-time tables (slot masks, prefix
// sums, K x L logits, row tables) grow with the stage: at the decode
// shapes (L 128) they sit in shared memory; when they would take the plan
// past 227 KB (K 30, Dh 64 beyond ~520 times) they move to a global
// workspace that the caller allocates (mmt_beam_select_workspace_bytes
// says how large; the wrapper takes a torch.empty, so a captured graph
// holds no allocation of its own), and the ancestry is read in place. What
// then stays in shared memory depends on K and head_dim only, and fits for
// every K x head_dim <= 8192 (ops/beam_attention.py beam_kernel_supports).
// The launcher raises the kernel's shared-memory limit at the first launch
// of a plan (cudaFuncSetAttribute, not a stream operation); a decode step
// is run eagerly once per stage before its graph is captured, which does
// that before capture.
//
// What is left: on the card the kernel is limited by its instruction
// stream, not by bytes (its time hardly changes when every beam shares one
// slot and the rows to read fall tenfold): per cached element the FMA path
// spends a load share, two instructions of conversion (int8) and one FMA,
// twice (logits, values). The dense per-time K x K products would fit
// mma.sync but waste K-fold work on slots a beam does not read. The
// register budget follows the plan: 3 blocks per SM where shared memory
// allows (K 10), else 2 (K 30).
//
// Cross attention reads each batch row's encoder K/V once per head and does
// ~4 K flops per element of it (K <= 30 beams): bound by bytes, and at the
// flagship's Ls 26 by latency. A block stages q (K x Dh) and its keys' K/V
// rows and bias with 16-byte cp.async copies, all in flight together; for
// bf16 it computes S = Q K^T and P V on the tensor cores (mma.sync
// m16n8k16, K padded to 16 rows, keys to 16, head_dim to 16), S goes through
// shared memory for the exact fp32 softmax with the additive bias, and P =
// exp(S - m) / l with the row's max m and sum l is rounded to bf16 before
// P V, where the plain version and the Pallas kernel round it. fp32 (fp32
// models, tests) runs the same staged structure on the FMA pipes.
//
// Ls up to the plan's one-pass limit (cross_plan below; Ls
// 26 for the flagship) is one pass: block (b, h) takes every key. Longer
// encoders take tiles of the plan's keys, a block each, grid (tiles, heads,
// batch), so that every block's copies are in flight at once and a small
// batch still fills the card. The P rounding needs each row's global m and l
// before any P V, and the tiles' P V partials have to be added: an exchange
// between the blocks of one (row, head).
//
// Up to kClusterKeys keys in bf16 at head_dim 64 and up to 32 beams (the
// multimodal recipe's Ls 279 at K 10 is 2 tiles of 160 keys), the blocks of
// one (row, head) form one thread block cluster, and the exchange goes
// through distributed shared memory: one launch, no workspace. Each block
// stages q, its K rows and bias, then its V rows, and each of its warps
// takes 32 keys in mma fragments: S = q K^T, each beam's max mx over the
// warp's keys and e = exp(S - mx) with their sum (quad shuffles), which the
// warp writes into every rank's shared memory. A block may write there only
// once every block of its cluster has started: each block makes a relaxed
// arrival at the cluster barrier on entry and waits for it just before
// these writes, so the staging and the products hide the wait. After a
// cluster barrier every block folds all (rank, warp) pairs, in one order,
// into each beam's m and l (the same bits in every block), forms P = e
// exp(mx - m) / l, rounded to bf16 straight into the A operand of P V (S's
// m16n8 accumulators of two key tiles are P's m16k16 operand), and writes
// its fp32 P V partial of each beam row into the shared memory of the rank
// that adds that row; after a second barrier each rank adds its rows'
// partials in (rank, warp) order (two calls are bit-equal) and writes them.
// P as e exp(mx - m) / l reuses the exp(S - mx) the warp's sum took, so each
// key costs one exp, not two; it equals exp(S - m) / l, the plain version's
// and the other forms' arithmetic, but as a product of two fp32 exps it
// carries a few more fp32 roundings, so a P can land one bf16 step from
// theirs (within the tests' limits; PERF.md gives what it moves end to end).
// What it replaces, the split form's round trip through device memory
// (each tile's logits written by a stats launch and read back by a value
// launch, fp32 partials written and read by the last block, an atomic
// ticket, a second launch's ramp), moved ~117 MB a call at B 128, K 10, Ls
// 279 against the ~77 MB of q, the K and V rows and the output that the
// cluster form moves. What bounds it on the H100 (PERF.md): instruction
// throughput, and the cluster barriers (a quarter of its time), more than
// the HBM rate: its copies alone run at ~2.6 TB/s, its products without the
// barriers take 3/4 of its time. Hence the plan's few warps a rank (fewer
// ranks wait less at each barrier), and a warp's chain kept in registers.
//
// From kClusterKeys + 1 to kStreamKeys keys (an RLE source's up to 4090)
// in bf16 at head_dim 64 and up to 32 beams, the stream form: one launch
// of clusters of up to 8 ranks, no workspace, each rank (block) streaming
// its keys rather than staging them, so that HBM stays busy. The keys go in
// chunks of 32 (a 4 KB TMA box of a (batch, Ls, D) map, 128-byte swizzled;
// rows past Ls read as zero), rank t taking chunks t, t + ranks, ..., so
// that each rank holds about as many of a row's valid keys as the others.
// Up to 4 consumer warps a rank take its chunks in turn, each through a
// ring of its own (full and empty mbarriers) that one lane of the block's
// loading warp fills in chunk order: each ring has one filler and one
// consumer, so no wait runs a phase ahead (a ring shared by the warps let a
// wait pass on an earlier phase when TMA copies landed out of order). A
// consumer warp keeps S = q K^T + bias of its up to 4 chunks in mma
// fragments. The rank's max of each beam row (through shared memory)
// makes a chunk live where some beam's largest logit there lies within
// kSkipLogit of it; the loader streams the live chunks' V rows while the
// warps push each (warp, beam)'s max and sum of exp(S - max) into every
// rank (after the relaxed arrival made on entry has been waited for), meet
// at a cluster barrier and fold all (rank, warp) pairs, in one order, into
// each beam's m and l. A chunk dead for the rank is dead for m; one live
// for the rank but not for m adds exactly 0. Then P = exp(S - m) / l, the
// split form's arithmetic (a second exp a key), rounded to bf16 into P V's
// A operand; each warp's fp32 partial of a beam row goes to the rank that
// adds that row, which adds them in (rank, warp) order after a second
// barrier (two calls are bit-equal). More than 16 beams take two clusters,
// one per 16-row half, which read the same K and V rows (the second mostly
// from L2). What bounds it on the H100 (PERF.md): at B 128, Ls 4090 it
// reads every key's K row and the live chunks' V rows (~0.95 GB at the RLE
// lengths) at ~2.0 TB/s at K 10 and ~2.3 TB/s at K 1; its phases (K, the
// exchange, V, a block's start and end) with three blocks an SM keep HBM
// below its rate, and P's exp and division take about a fifth of the time
// at K 10. Measured slower: deeper rings, two or four blocks an SM,
// persistent clusters looping over (row, head) pairs, ranks of two 16-row
// tiles for K 17-32, and clusters of 16.
//
// Other encoders past one pass (fp32, head_dim other than 64, more than 32
// beams, more than kStreamKeys keys) take the split form, two launches. The
// first computes each tile's logits and their max and sum (reading K and
// the bias only) and writes the logits to the workspace (reading 8 K bytes
// a key back measured faster than reading K again and recomputing them, at
// K 1, 10 and 30). The second folds the stats into m and l, skips every
// tile whose largest logit lies more than kSkipLogit below each beam's m
// (it adds exactly 0: a padded tail reads no logits or V there), forms P
// and the tile's fp32 P V partial, and the last block of each (row, head),
// found by an atomic ticket, adds the live partials in tile order, so that
// two calls are bit-equal. The workspace (tickets, stats, partials, logits)
// is a torch tensor the wrapper allocates, so a captured decode graph holds
// it in its pool. What bounds the split form on the H100 (PERF.md):
// instruction issue more than the HBM rate. Each tile's block runs a
// serial chain of copies, products, row reductions and the ticket, and
// about 8 blocks share an SM; at K 30 the workspace's logits and partials
// also double the bytes of K and V. At an RLE encoder's Ls 4090 it moved
// ~1.7x the bytes of its bound, and lost to SDPA.
//
// The TPU kernel's block-diagonal head packing, 64-row aligned append
// window and lane-padded scale operands exist for the TPU's matrix unit and
// Mosaic's tiling; none of them carries over.

#include <cooperative_groups.h>

#include "common.cuh"
#include "tma.cuh"

namespace mmt {
namespace {

constexpr int kSelectThreads = 256;
constexpr size_t kSmemPerSm = 233472;   // 228 KB of shared memory per SM
constexpr int kStages = 2;
constexpr int kStageBytes = 24 * 1024;
constexpr int kRowPad = 16;
constexpr int kCrossThreads = 256;
constexpr int kCrossOnePassKeys = 256;
constexpr int kCrossTileKeys = 128;
// The cluster form: at most the portable cluster size of tiles, a block
// each, of 32 keys a warp and at most 5 warps (4 blocks to an SM), at most
// 1024 keys in all (a lane of one warp per (rank, warp) in the fold), at
// this head size.
constexpr int kClusterTiles = 8;
constexpr int kClusterWarpKeys = 32;
constexpr int kClusterMaxWarps = 5;
constexpr int kClusterKeys = 32 * kClusterWarpKeys;
constexpr int kClusterDh = 64;
// The stream form: 1025 to kStreamKeys keys at this head size, bf16, up to
// 32 beams (in 16-row halves); chunks of 32 keys (one 4 KB TMA box of K or
// V rows), a ring of kStreamWarpStages chunks for each consumer warp, up to
// kStreamMaxWarps consumer warps a rank, each keeping the logits of
// kStreamWarpChunks chunks in registers, and up to kStreamMaxRanks ranks a
// cluster.
constexpr int kStreamKeys = 4096;
constexpr int kStreamChunkKeys = 32;
constexpr int kStreamChunkBytes = kStreamChunkKeys * kClusterDh * 2;
constexpr int kStreamWarpStages = 2;
constexpr int kStreamWarpChunks = 4;
constexpr int kStreamMaxWarps = 4;
constexpr int kStreamMaxRanks = 8;
// A tile whose largest logit lies more than this below its row's max holds
// only keys whose exp(S - max) is exactly 0 in fp32 (it underflows past
// about -104; the margin leaves room for expf's last-bit error).
constexpr float kSkipLogit = 128.f;
constexpr int kMaxHeadDim = 256;
constexpr size_t kMaxSmem = 232448;   // 227 KB of dynamic shared memory per block
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory plan of the select kernel for up to `steps` attended times
// (the stage length). The per-time tables (slot masks, prefix sums, the K x
// steps logits, the staged-row tables) grow with the stage; when they would
// take the plan past kMaxSmem they `spill` to a global workspace of
// `workspace` bytes per block (the ancestry is then read in place), and
// what stays in shared memory depends on K and head_dim only.
struct SelectLayout {
  int row_bytes;    // head slice of one cache row
  int row_stride;   // staged row pitch: row_bytes + kRowPad
  int times;        // times per tile
  int stage_bytes;  // one ring stage: up to times * K rows (+ their int8 scales)
  int words;        // 32-bit words of one time's slot mask
  int split;        // share of the times per value-pass thread group
  bool spill;       // the per-time tables are in the workspace
  // The first region holds the prologue's raw copies (bf16 queries, fresh
  // rows, int32 ancestry) and the slot masks, and then the ring.
  size_t off_anc_raw;
  size_t off_fresh, off_fresh_scale, off_q, off_acc, off_tile;
  // Offsets of the per-time tables: in shared memory, or in the workspace.
  size_t off_sel, off_logit, off_idx, off_src, off_prefix;
  size_t total, workspace;
};

__host__ __device__ inline SelectLayout select_layout(int beams, int head_dim, int steps,
                                                      int elt, int new_elt, bool quantized,
                                                      bool update, bool spill) {
  SelectLayout l;
  l.row_bytes = head_dim * elt;
  l.row_stride = l.row_bytes + kRowPad;
  // As many times per tile as give every thread at most one (beam, time)
  // pair, as far as kStageBytes of staged rows allow.
  const int per_time = beams * (l.row_stride + (quantized ? 4 : 0));
  l.times = imax(1, imin(imin(steps, kSelectThreads / beams), kStageBytes / per_time));
  const int rows = l.times * beams;
  l.stage_bytes = static_cast<int>(align16(static_cast<size_t>(rows) * l.row_stride +
                                           (quantized ? rows * 4 : 0)));
  l.words = (beams + 31) / 32;
  l.split = imax(1, kSelectThreads / (beams * (head_dim / 8)));
  l.spill = spill;
  size_t ws = 0;
  size_t raw = align16(static_cast<size_t>(beams) * head_dim * 2) +
               (update ? align16(2 * static_cast<size_t>(beams) * head_dim * new_elt) : 0);
  l.off_anc_raw = raw;
  size_t& sel = spill ? ws : raw;
  if (!spill) raw += align16(static_cast<size_t>(beams) * steps * 4);
  l.off_sel = sel;
  sel += align16(static_cast<size_t>(steps) * l.words * 4);
  const size_t ring = static_cast<size_t>(kStages) * l.stage_bytes;
  size_t off = align16(ring > raw ? ring : raw);
  l.off_fresh = off;
  off += update ? align16(2 * static_cast<size_t>(beams) * l.row_stride) : 0;
  l.off_fresh_scale = off;
  off += update && quantized ? align16(2 * static_cast<size_t>(beams) * 4) : 0;
  l.off_q = off;
  off += align16(static_cast<size_t>(beams) * head_dim * 4);
  l.off_acc = off;
  off += align16(static_cast<size_t>(l.split) * beams * head_dim * 4);
  l.off_tile = off;
  off += align16(static_cast<size_t>(l.times) * beams * 8);
  size_t& tab = spill ? ws : off;
  l.off_logit = tab;
  tab += align16(static_cast<size_t>(beams) * steps * 4);
  l.off_idx = tab;
  tab += align16(static_cast<size_t>(beams) * steps * 2);
  l.off_src = tab;
  tab += align16(static_cast<size_t>(beams) * steps * 2);
  l.off_prefix = tab;
  tab += align16((static_cast<size_t>(steps) + 1) * 4);
  l.total = off;
  l.workspace = ws;
  return l;
}

// Shared-memory plan of a cross-attention block over `chunk` keys: the
// beams' q rows, the keys' K rows and bias (`keys`: the block computes the
// logits; else it reads them back from the workspace), the V rows
// (`values`), the logits, P and the output (`values`), the beams' max and
// sum, and for the split form's value block (`tiles` > 0) a live flag per
// tile of its (row, head) and the last-block flag.
struct CrossLayout {
  int m_pad, dk, q_stride, k_stride, v_stride, s_stride, p_stride;
  size_t off_k, off_v, off_bias, off_s, off_p, off_o, off_stat, off_live, total;
};

__host__ __device__ inline CrossLayout cross_layout(int beams, int head_dim, int chunk, int elt,
                                                    bool keys, bool values, int tiles) {
  CrossLayout l;
  l.m_pad = round_up(beams, 16);
  l.dk = round_up(head_dim, 16);
  l.q_stride = l.dk + 8;
  l.k_stride = l.dk + 8;
  l.v_stride = head_dim + 8;
  l.s_stride = chunk + 4;
  l.p_stride = chunk + 8;
  size_t off = keys ? align16(static_cast<size_t>(l.m_pad) * l.q_stride * elt) : 0;  // q at 0
  l.off_k = off;
  off += keys ? align16(static_cast<size_t>(chunk) * l.k_stride * elt) : 0;
  l.off_v = off;
  off += values ? align16(static_cast<size_t>(chunk) * l.v_stride * elt) : 0;
  l.off_bias = off;
  off += keys ? align16(static_cast<size_t>(chunk) * 4) : 0;
  l.off_s = off;
  off += align16(static_cast<size_t>(l.m_pad) * l.s_stride * 4);
  l.off_p = off;
  off += values ? align16(static_cast<size_t>(l.m_pad) * l.p_stride * elt) : 0;
  l.off_o = off;
  off += values ? align16(static_cast<size_t>(l.m_pad) * head_dim * 4) : 0;
  l.off_stat = off;
  off += align16(static_cast<size_t>(l.m_pad) * 2 * 4);
  l.off_live = off;
  off += tiles > 0 ? align16((static_cast<size_t>(tiles) + 1) * 4) : 0;
  l.total = off;
  return l;
}

// Shared-memory plan of a cluster-form block (head_dim kClusterDh, mt
// 16-row tiles of beams, `warps` x kClusterWarpKeys keys, `tiles` ranks):
// the beams' q rows, the tile's K rows (once the logits are done, the room
// where the peers put their fp32 P V partials of this rank's slice of the
// outputs: `tiles` x cluster_puts(mt, warps) slices of `slice` beam rows),
// its V rows, its bias, every (rank, warp, beam)'s max and sum, put there by
// the peers, and each beam's m and l.
struct ClusterLayout {
  int slice;   // the beam rows of outputs a rank adds
  size_t off_k, off_v, off_bias, off_stat, off_ml, total;
};

// Partials a block puts per beam row: one a warp, or with two 16-row tiles
// of beams one a pair of warps (so that they fit the K rows' room).
__host__ __device__ constexpr int cluster_puts(int mt, int warps) {
  return mt == 1 ? warps : warps / 2;
}

__host__ __device__ inline ClusterLayout cluster_layout(int beams, int tiles, int warps) {
  ClusterLayout l;
  const int mt = (beams + 15) / 16;
  const size_t row = (kClusterDh + 8) * 2;   // a staged bf16 row, padded
  const size_t rows = static_cast<size_t>(warps) * kClusterWarpKeys * row;
  l.slice = (beams + tiles - 1) / tiles;
  const size_t parts =
      static_cast<size_t>(tiles) * cluster_puts(mt, warps) * l.slice * kClusterDh * 4;
  l.off_k = align16(16 * mt * row);           // q at 0
  l.off_v = l.off_k + align16(parts > rows ? parts : rows);
  l.off_bias = l.off_v + rows;
  l.off_stat = l.off_bias + static_cast<size_t>(warps) * kClusterWarpKeys * 4;
  l.off_ml = l.off_stat + static_cast<size_t>(tiles) * warps * 16 * mt * 8;
  l.total = l.off_ml + 16 * mt * 8;
  return l;
}

// Shared-memory plan of a stream-form block (`rows` beams of a 16-row
// half, `ranks` ranks of `warps` consumer warps): each warp's ring of kStreamWarpStages chunks at the
// 1024-byte aligned base, every (rank, warp, beam)'s max and sum (put there
// by the peers), each beam's m and l, each (warp, beam)'s max, the (rank,
// warp) fp32 P V partials of this rank's `slice` beam rows (put there by
// the peers), the rings' full and empty mbarriers and the live-chunk mask;
// `total` has the slack that aligns the base.
struct StreamLayout {
  int slice;
  size_t off_stat, off_ml, off_wmax, off_part, off_bar, off_mask, total;
};

__host__ __device__ inline StreamLayout stream_layout(int rows, int ranks, int warps) {
  StreamLayout l;
  const size_t m_pad = 16;
  const size_t stages = static_cast<size_t>(warps) * kStreamWarpStages;
  l.slice = (rows + ranks - 1) / ranks;
  l.off_stat = stages * kStreamChunkBytes;
  l.off_ml = l.off_stat + static_cast<size_t>(ranks) * warps * m_pad * 8;
  l.off_wmax = l.off_ml + m_pad * 8;
  l.off_part = l.off_wmax + static_cast<size_t>(warps) * m_pad * 4;
  l.off_bar = l.off_part + static_cast<size_t>(ranks) * warps * l.slice * kClusterDh * 4;
  l.off_mask = l.off_bar + 2 * stages * 8;
  l.total = l.off_mask + 16 + 1024;
  return l;
}

// Global workspace of the split form: one ticket per (row, head), then per
// (row, head, tile, beam) the tile's logit max and sum of exp(S - max), its
// fp32 P V partial and its logits, tile_keys of them.
struct CrossWorkspace {
  size_t off_stats, off_part, off_logits, total;
};

__host__ __device__ inline CrossWorkspace cross_workspace(int batch, int beams, int heads,
                                                          int head_dim, int tiles,
                                                          int tile_keys) {
  CrossWorkspace w;
  const size_t rows = static_cast<size_t>(batch) * heads * tiles * beams;
  size_t off = align16(static_cast<size_t>(batch) * heads * 4);
  w.off_stats = off;
  off += align16(rows * 8);
  w.off_part = off;
  off += align16(rows * head_dim * 4);
  w.off_logits = off;
  off += align16(rows * tile_keys * 4);
  w.total = off;
  return w;
}

// ---------------------------------------------------------------- copies
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(kBytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// `bytes` (a multiple of 8) from global to shared memory in 16-byte copies,
// or 8-byte ones where `bytes` is not a multiple of 16 (int8 rows of a
// head_dim that is not a multiple of 16); `part` picks this thread's piece.
__device__ __forceinline__ void cp_async_piece(unsigned char* dst, const unsigned char* src,
                                               int wide, int part) {
  if (wide) {
    cp_async<16>(dst + 16 * part, src + 16 * part);
  } else {
    cp_async<8>(dst + 8 * part, src + 8 * part);
  }
}

// fp32 dot of a query (fp32, shared memory, 32-byte aligned) with a staged
// row: eight partial sums (one per element of each 8-element piece), so
// that the FMAs do not wait on one another, added pairwise at the end.
template <typename T>
__device__ __forceinline__ float staged_dot(const float* q, const T* row, int head_dim) {
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int d = 0; d < head_dim; d += 8) {
    float k[8];
    load8(row + d, k);
    const float4 a = *reinterpret_cast<const float4*>(q + d);
    const float4 b = *reinterpret_cast<const float4*>(q + d + 4);
    acc[0] = fmaf(a.x, k[0], acc[0]);
    acc[1] = fmaf(a.y, k[1], acc[1]);
    acc[2] = fmaf(a.z, k[2], acc[2]);
    acc[3] = fmaf(a.w, k[3], acc[3]);
    acc[4] = fmaf(b.x, k[4], acc[4]);
    acc[5] = fmaf(b.y, k[5], acc[5]);
    acc[6] = fmaf(b.z, k[6], acc[6]);
    acc[7] = fmaf(b.w, k[7], acc[7]);
  }
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

// ------------------------------------------------------- select attention
// Grid (heads, batch), kSelectThreads threads. T: the cache type (int8 or
// bf16); TNew: the fresh rows' type (update mode; bf16, or fp32 for an int8
// cache in an fp32 model).
// kBlocks: the blocks per SM the registers are budgeted for (the launcher
// picks 3 where the shared-memory plan lets 3 blocks share an SM, else 2).
// `spill`: the per-time tables of every block are in `workspace`
// (select_layout's `workspace` bytes each). `pos_ptr`: the step index in
// device memory; `length`: the stage length the plan is sized for.
template <typename T, typename TNew, bool kUpdate, int kBlocks>
__global__ void __launch_bounds__(kSelectThreads, kBlocks) select_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const TNew* __restrict__ k_new,
    const TNew* __restrict__ v_new, T* cache, float* scales, const int* __restrict__ ancestry,
    __nv_bfloat16* __restrict__ out, unsigned char* workspace, int batch, int beams, int heads,
    int head_dim, int flat, int flat_pad, int anc_row_stride, const int* __restrict__ pos_ptr,
    int length, bool spill, float scale) {
  constexpr bool kQuantized = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int pos = *pos_ptr;
  const int steps = pos + 1;
  const int d_model = heads * head_dim;
  const size_t row0 = static_cast<size_t>(b) * beams;
  const size_t head_off = static_cast<size_t>(h) * head_dim;
  if (pos < 0 || pos >= length) {
    const __nv_bfloat16 nan = __float2bfloat16_rn(__int_as_float(0x7fc00000));
    for (int i = tid; i < beams * head_dim; i += nthreads) {
      out[(row0 + i / head_dim) * d_model + head_off + i % head_dim] = nan;
    }
    return;
  }
  const SelectLayout lay = select_layout(beams, head_dim, length, sizeof(T), sizeof(TNew),
                                         kQuantized, kUpdate, spill);
  const size_t plane = static_cast<size_t>(batch) * flat * d_model;  // K -> V plane, elements
  T* kv = cache + static_cast<size_t>(b) * flat * d_model + head_off;
  const size_t scale_plane = static_cast<size_t>(batch) * heads * flat_pad;
  float* sc = kQuantized ? scales + (static_cast<size_t>(b) * heads + h) * flat_pad : nullptr;
  const int words = lay.words;
  unsigned char* tables =
      lay.spill ? workspace + (static_cast<size_t>(b) * heads + h) * lay.workspace : smem;

  auto* q_raw = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* new_raw = reinterpret_cast<TNew*>(
      smem + align16(static_cast<size_t>(beams) * head_dim * 2));
  // Beam n's ancestry row: staged at (K, steps), or read in place.
  const int* anc = lay.spill ? ancestry + row0 * anc_row_stride
                             : reinterpret_cast<const int*>(smem + lay.off_anc_raw);
  const int anc_stride = lay.spill ? anc_row_stride : steps;
  uint32_t* sel_s = reinterpret_cast<uint32_t*>(tables + lay.off_sel);   // (steps, words)
  int* prefix = reinterpret_cast<int*>(tables + lay.off_prefix);          // (steps + 1)
  unsigned char* fresh = smem + lay.off_fresh;                          // (2, K) staged rows
  float* fresh_scale = reinterpret_cast<float*>(smem + lay.off_fresh_scale);  // (2, K)
  float* q_s = reinterpret_cast<float*>(smem + lay.off_q);              // (K, Dh)
  float* acc_s = reinterpret_cast<float*>(smem + lay.off_acc);          // (split, K, Dh)
  float* tile_w = reinterpret_cast<float*>(smem + lay.off_tile);         // (K, T) weights
  int* tile_off = reinterpret_cast<int*>(tile_w + lay.times * beams);    // (K, T) row offsets
  float* logit_s = reinterpret_cast<float*>(tables + lay.off_logit);    // (K, steps)
  uint16_t* idx_s = reinterpret_cast<uint16_t*>(tables + lay.off_idx);  // (K, steps)
  uint16_t* src_s = reinterpret_cast<uint16_t*>(tables + lay.off_src);  // staged row -> t*K+s

  // 1. Prologue: one round of asynchronous copies of the bf16 queries, the
  // fresh rows and (unless spilled) the ancestry rows.
  {
    const int q_pieces = head_dim / 8;  // 16 bytes of bf16 each
    for (int i = tid; i < beams * q_pieces; i += nthreads) {
      const int n = i / q_pieces;
      const int c = i - n * q_pieces;
      cp_async<16>(q_raw + n * head_dim + 8 * c, q + (row0 + n) * d_model + head_off + 8 * c);
    }
    if constexpr (kUpdate) {
      constexpr int kPer = 16 / sizeof(TNew);
      const int pieces = head_dim / kPer;
      for (int i = tid; i < 2 * beams * pieces; i += nthreads) {
        const int r = i / pieces;  // p * beams + n
        const int c = i - r * pieces;
        const int n = r < beams ? r : r - beams;
        const TNew* src = (r < beams ? k_new : v_new) + (row0 + n) * d_model + head_off + kPer * c;
        cp_async<16>(new_raw + r * head_dim + kPer * c, src);
      }
    }
    for (int i = tid; !lay.spill && i < beams * steps; i += nthreads) {
      const int n = i / steps;
      cp_async<4>(smem + lay.off_anc_raw + 4 * i,
                  ancestry + (row0 + n) * anc_row_stride + (i - n * steps));
    }
    cp_async_commit();
  }
  for (int i = tid; i < steps * words; i += nthreads) sel_s[i] = 0u;
  for (int i = tid; i < lay.split * beams * head_dim; i += nthreads) acc_s[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // 2. Queries; the slot mask of every time (in update mode time pos is
  // each beam's own fresh row, never staged from the cache).
  for (int i = tid; i < beams * head_dim; i += nthreads) {
    q_s[i] = round_bf16(__bfloat162float(q_raw[i]) * scale);
  }
  for (int i = tid; i < beams * steps; i += nthreads) {
    const int n = i / steps;
    const int t = i - n * steps;
    if (kUpdate && t == pos) continue;
    const int s = anc[n * anc_stride + t];
    atomicOr(&sel_s[t * words + (s >> 5)], 1u << (s & 31));
  }
  if constexpr (kUpdate) {
    if constexpr (kQuantized) {
      // One thread per (plane, beam) row: fp32 absmax (each thread starts at
      // its own column, so the row reads spread over the banks), then the
      // scale, as quantize_kv_heads computes it.
      for (int r = tid; r < 2 * beams; r += nthreads) {
        const TNew* x = new_raw + r * head_dim;
        float amax = 0.f;
        for (int e = 0, d = r % head_dim; e < head_dim; ++e, d = d + 1 == head_dim ? 0 : d + 1) {
          amax = fmaxf(amax, fabsf(to_f32(x[d])));
        }
        const float s = fmaxf(amax, 1e-8f) / 127.0f;
        fresh_scale[r] = s;
        sc[(r < beams ? 0 : scale_plane) + pos * beams + (r < beams ? r : r - beams)] = s;
      }
      __syncthreads();
      for (int i = tid; i < 2 * beams * head_dim; i += nthreads) {
        const int r = i / head_dim;  // p * beams + n
        const int d = i - r * head_dim;
        const int n = r < beams ? r : r - beams;
        const float qv = fminf(fmaxf(rintf(to_f32(new_raw[i]) / fresh_scale[r]), -127.f), 127.f);
        const int8_t v = static_cast<int8_t>(qv);
        reinterpret_cast<int8_t*>(fresh + r * lay.row_stride)[d] = v;
        kv[(r < beams ? 0 : plane) + static_cast<size_t>(pos * beams + n) * d_model + d] = v;
      }
    } else {
      for (int i = tid; i < 2 * beams * head_dim; i += nthreads) {
        const int r = i / head_dim;
        const int d = i - r * head_dim;
        const int n = r < beams ? r : r - beams;
        const T v = new_raw[i];
        reinterpret_cast<T*>(fresh + r * lay.row_stride)[d] = v;
        kv[(r < beams ? 0 : plane) + static_cast<size_t>(pos * beams + n) * d_model + d] = v;
      }
    }
  }
  __syncthreads();

  // 3. Exclusive prefix sums of the selected slots per time (warp 0), then
  // every selected (time, slot) its place among the staged rows, and every
  // (beam, time) the staged row it reads.
  if (tid < 32) {
    int carry = 0;
    for (int t0 = 0; t0 < steps; t0 += 32) {
      const int t = t0 + lane;
      int count = 0;
      if (t < steps) {
        for (int w = 0; w < words; ++w) count += __popc(sel_s[t * words + w]);
      }
      int incl = count;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kFullMask, incl, o);
        if (lane >= o) incl += v;
      }
      if (t < steps) prefix[t] = carry + incl - count;
      carry += __shfl_sync(kFullMask, incl, 31);
    }
    if (lane == 0) prefix[steps] = carry;
  }
  __syncthreads();
  auto rank = [&](int t, int s) -> int {
    int r = prefix[t];
    for (int w = 0; w < (s >> 5); ++w) r += __popc(sel_s[t * words + w]);
    return r + __popc(sel_s[t * words + (s >> 5)] & ((1u << (s & 31)) - 1u));
  };
  for (int i = tid; i < beams * steps; i += nthreads) {
    const int t = i / beams;
    const int s = i - t * beams;
    if ((sel_s[t * words + (s >> 5)] >> (s & 31)) & 1u) src_s[rank(t, s)] = static_cast<uint16_t>(i);
  }
  for (int i = tid; i < beams * steps; i += nthreads) {
    const int n = i / steps;
    const int t = i - n * steps;
    if (!(kUpdate && t == pos)) idx_s[i] = static_cast<uint16_t>(rank(t, anc[n * anc_stride + t]));
  }
  __syncthreads();   // the first region becomes the ring below

  // 4. The tiles: K rows of times [c * T, c * T + T) for c < C, then V rows;
  // tile c stages the selected rows prefix[c * T] .. prefix[c * T + T) - 1.
  const int per = imin(steps, lay.times);
  const int chunks = (steps + per - 1) / per;
  const int n_tiles = 2 * chunks;
  const int wide = lay.row_bytes % 16 == 0;
  const int pieces = lay.row_bytes / (wide ? 16 : 8);
  const int row_step = nthreads / pieces;  // rows staged per pass
  const int my_piece = tid % pieces;
  const int my_row = tid < row_step * pieces ? tid / pieces : -1;
  const int scale_off = per * beams * lay.row_stride;

  auto issue = [&](int j) {
    if (j < n_tiles) {
      const int p = j < chunks ? 0 : 1;
      const int c = j - p * chunks;
      const int first = prefix[c * per];
      const int rows = prefix[imin(steps, c * per + per)] - first;
      unsigned char* st = smem + static_cast<size_t>(j % kStages) * lay.stage_bytes;
      const T* src = kv + p * plane;
      for (int r = my_row; r >= 0 && r < rows; r += row_step) {
        cp_async_piece(st + r * lay.row_stride,
                       reinterpret_cast<const unsigned char*>(
                           src + static_cast<size_t>(src_s[first + r]) * d_model),
                       wide, my_piece);
      }
      if constexpr (kQuantized) {
        float* st_scale = reinterpret_cast<float*>(st + scale_off);
        for (int r = tid; r < rows; r += nthreads) {
          cp_async<4>(st_scale + r, sc + p * scale_plane + src_s[first + r]);
        }
      }
    }
    cp_async_commit();
  };

  for (int j = 0; j < kStages - 1; ++j) issue(j);
  const int groups = head_dim / 8;
  const int items = beams * groups;
  for (int j = 0; j < n_tiles; ++j) {
    issue(j + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const int p = j < chunks ? 0 : 1;
    const int t0 = (j - p * chunks) * per;
    const int nt = imin(per, steps - t0);
    const int first = prefix[t0];
    const unsigned char* st = smem + static_cast<size_t>(j % kStages) * lay.stage_bytes;
    const float* st_scale = reinterpret_cast<const float*>(st + scale_off);
    const unsigned char* fresh_p = fresh + p * beams * lay.row_stride;
    const float* fresh_scale_p = fresh_scale + p * beams;
    if (p == 0) {
      for (int i = tid; i < beams * nt; i += nthreads) {
        const int n = i / nt;
        const int t = t0 + (i - n * nt);
        const bool own = kUpdate && t == pos;
        const int r = own ? 0 : idx_s[n * steps + t] - first;
        const T* row = reinterpret_cast<const T*>(own ? fresh_p + n * lay.row_stride
                                                      : st + r * lay.row_stride);
        const float dot = staged_dot(q_s + n * head_dim, row, head_dim);
        logit_s[n * steps + t] =
            kQuantized ? dot * (own ? fresh_scale_p[n] : st_scale[r]) : dot;
      }
    } else {
      // This tile's (beam, time) pairs: the probability times the value
      // row's int8 scale, rounded to bf16, and the staged row it weighs.
      for (int i = tid; i < beams * nt; i += nthreads) {
        const int n = i / nt;
        const int t = t0 + (i - n * nt);
        const bool own = kUpdate && t == pos;
        const int r = own ? 0 : idx_s[n * steps + t] - first;
        float wgt = logit_s[n * steps + t];
        if (kQuantized) wgt *= own ? fresh_scale_p[n] : st_scale[r];
        tile_w[i] = round_bf16(wgt);
        tile_off[i] = static_cast<int>((own ? fresh_p + n * lay.row_stride
                                            : st + r * lay.row_stride) - smem);
      }
      __syncthreads();
      for (int w = tid; w < items * lay.split; w += nthreads) {
        const int ts = w / items;
        const int it = w - ts * items;
        const int n = it / groups;
        const int g = it - n * groups;
        float* acc = acc_s + (static_cast<size_t>(ts) * beams + n) * head_dim + 8 * g;
        const float* wn = tile_w + n * nt;
        const int* offn = tile_off + n * nt;
        float a[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) a[e] = acc[e];
#pragma unroll 4
        for (int tl = ts; tl < nt; tl += lay.split) {
          float v[8];
          load8(reinterpret_cast<const T*>(smem + offn[tl]) + 8 * g, v);
          const float wgt = wn[tl];
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e] = fmaf(wgt, v[e], a[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = a[e];
      }
    }
    __syncthreads();
    if (j == chunks - 1) {
      // Exact softmax per beam, in place: the normalised probabilities.
      for (int n = tid >> 5; n < beams; n += nthreads >> 5) {
        float* l = logit_s + n * steps;
        float m = -INFINITY;
        for (int t = lane; t < steps; t += 32) m = fmaxf(m, l[t]);
        m = warp_max(m);
        float sum = 0.f;
        for (int t = lane; t < steps; t += 32) sum += expf(l[t] - m);
        sum = warp_sum(sum);
        for (int t = lane; t < steps; t += 32) l[t] = expf(l[t] - m) / sum;
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();

  for (int i = tid; i < beams * head_dim; i += nthreads) {
    const int n = i / head_dim;
    const int d = i - n * head_dim;
    float o = 0.f;
    for (int ts = 0; ts < lay.split; ++ts) o += acc_s[static_cast<size_t>(ts) * beams * head_dim + i];
    out[(row0 + n) * d_model + head_off + d] = __float2bfloat16_rn(o);
  }
}

// ------------------------------------------------------- cross attention
__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Fragments of 8 x 8 bf16 matrices from shared memory: each lane gives one
// 16-byte row address (lanes 0-7 matrix 0, 8-15 matrix 1, ...), each lane
// receives its pair of every matrix as mma.sync lays A and B out (.trans:
// of the transposed matrix).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t r[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// S[m][j] = q_s[m] . k_s[j] + bias[j] for the chunk's nk keys (-inf past
// them), m over the padded beams.
template <typename T>
__device__ __forceinline__ void cross_logits(const CrossLayout& l, const T* q_s, const T* k_s,
                                             const float* bias_s, float* s_s, int beams,
                                             int head_dim, int nk, int nk_pad) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, gc = lane & 3;
    const int mt = l.m_pad / 16, ntl = nk_pad / 8;
    // ldmatrix row addresses: lane l names row l & 7 of 8 x 8 matrix l >> 3
    // (A: rows m0.., m0 + 8.. at columns kk, kk + 8; B: keys n0.. at kk, kk + 8).
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
    const int b_row = lane & 7, b_col = ((lane >> 3) & 1) * 8;
    for (int tile = warp; tile < mt * ntl; tile += blockDim.x >> 5) {
      const int m0 = (tile / ntl) * 16, n0 = (tile % ntl) * 8;
      const T* qa = q_s + (m0 + a_row) * l.q_stride + a_col;
      const T* kb = k_s + (n0 + b_row) * l.k_stride + b_col;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int kk = 0; kk < l.dk; kk += 16) {
        uint32_t a[4], b[2];
        ldsm_x4(a, qa + kk);
        ldsm_x2(b, kb + kk);
        mma_bf16(c, a[0], a[1], a[2], a[3], b[0], b[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + gr + (e >= 2 ? 8 : 0);
        const int j = n0 + 2 * gc + (e & 1);
        s_s[m * l.s_stride + j] = j < nk ? c[e] + bias_s[j] : -INFINITY;
      }
    }
  } else {
    for (int i = tid; i < beams * nk_pad; i += blockDim.x) {
      const int m = i / nk_pad, j = i - m * nk_pad;
      float acc = 0.f;
      if (j < nk) {
        for (int d = 0; d < head_dim; ++d) {
          acc = fmaf(to_f32(q_s[m * l.q_stride + d]), to_f32(k_s[j * l.k_stride + d]), acc);
        }
      }
      s_s[m * l.s_stride + j] = j < nk ? acc + bias_s[j] : -INFINITY;
    }
  }
}

// o_s[m][d] += P[m] . V[:, d] over the chunk's keys.
template <typename T>
__device__ __forceinline__ void cross_values(const CrossLayout& l, const T* p_s, const T* v_s,
                                             float* o_s, int beams, int head_dim, int nk,
                                             int nk_pad) {
  const int tid = threadIdx.x;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, gc = lane & 3;
    const int mt = l.m_pad / 16, ntl = head_dim / 8;
    // ldmatrix row addresses as in cross_logits; V's matrices are keys kk..
    // and kk + 8.. at columns n0.., transposed into the B fragment.
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
    const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    for (int tile = warp; tile < mt * ntl; tile += blockDim.x >> 5) {
      const int m0 = (tile / ntl) * 16, n0 = (tile % ntl) * 8;
      const T* pa = p_s + (m0 + a_row) * l.p_stride + a_col;
      const T* vb = v_s + b_row * l.v_stride + n0;
      float c[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[e] = o_s[(m0 + gr + (e >= 2 ? 8 : 0)) * head_dim + n0 + 2 * gc + (e & 1)];
      }
      for (int kk = 0; kk < nk_pad; kk += 16) {
        uint32_t a[4], b[2];
        ldsm_x4(a, pa + kk);
        ldsm_x2_trans(b, vb + kk * l.v_stride);
        mma_bf16(c, a[0], a[1], a[2], a[3], b[0], b[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o_s[(m0 + gr + (e >= 2 ? 8 : 0)) * head_dim + n0 + 2 * gc + (e & 1)] = c[e];
      }
    }
  } else {
    for (int i = tid; i < beams * head_dim; i += blockDim.x) {
      const int m = i / head_dim, d = i - m * head_dim;
      float acc = o_s[i];
      for (int j = 0; j < nk; ++j) {
        acc = fmaf(to_f32(p_s[m * l.p_stride + j]), to_f32(v_s[j * l.v_stride + d]), acc);
      }
      o_s[i] = acc;
    }
  }
}

// exp(x) (over l) where it is not exactly 0 in fp32: below -kSkipLogit it
// underflows, so a masked key (bias -1e9) costs no exponential or division.
__device__ __forceinline__ float exp_or_zero(float x) {
  return x < -kSkipLogit ? 0.f : expf(x);
}
__device__ __forceinline__ float prob(float x, float l) {
  return x < -kSkipLogit ? 0.f : expf(x) / l;
}

// `rows` rows of one head's slice (head_dim elements at src + j * d_model)
// staged at dst, pitch `stride`, with 16-byte cp.async copies (not
// committed): each thread copies one 16-byte piece of every step-th row, so
// that no copy pays an index division; rows [rows, rows_pad) and columns
// [head_dim, width) zero.
template <typename T>
__device__ __forceinline__ void stage_head_rows(T* dst, int stride, const T* src, int d_model,
                                                int rows, int rows_pad, int head_dim,
                                                int width) {
  constexpr int kPer = 16 / sizeof(T);
  const int pieces = head_dim / kPer;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int step = blockDim.x / pieces;   // rows per pass
  const int row = tid / pieces;
  const int col = (tid - row * pieces) * kPer;
  if (row < step) {
    const T* s = src + static_cast<size_t>(row) * d_model + col;
    T* d = dst + row * stride + col;
    for (int j = row; j < rows; j += step) {
      cp_async<16>(d, s);
      s += static_cast<size_t>(step) * d_model;
      d += step * stride;
    }
  }
  const T zero = from_f32<T>(0.f);
  for (int j = rows + warp; j < rows_pad; j += nwarps) {
    for (int c = lane; c < width; c += 32) dst[j * stride + c] = zero;
  }
  if (width > head_dim) {
    for (int j = warp; j < rows; j += nwarps) {
      for (int c = head_dim + lane; c < width; c += 32) dst[j * stride + c] = zero;
    }
  }
}

// The beams' q rows of head h and keys [j0, j0 + nk) of batch row b (K rows
// and bias), staged (not committed).
template <typename T>
__device__ __forceinline__ void stage_keys(const CrossLayout& l, unsigned char* smem, const T* q,
                                           const T* k, const float* bias, int b, int h,
                                           int beams, int heads, int head_dim, int ls, int j0,
                                           int nk) {
  const int d_model = heads * head_dim;
  const size_t head_off = static_cast<size_t>(h) * head_dim;
  stage_head_rows(reinterpret_cast<T*>(smem), l.q_stride,
                  q + static_cast<size_t>(b) * beams * d_model + head_off, d_model, beams,
                  l.m_pad, head_dim, l.dk);
  stage_head_rows(reinterpret_cast<T*>(smem + l.off_k), l.k_stride,
                  k + (static_cast<size_t>(b) * ls + j0) * d_model + head_off, d_model, nk,
                  round_up(nk, 16), head_dim, l.dk);
  float* bias_s = reinterpret_cast<float*>(smem + l.off_bias);
  for (int j = threadIdx.x; j < nk; j += blockDim.x) {
    cp_async<4>(bias_s + j, bias + static_cast<size_t>(b) * ls + j0 + j);
  }
}

// Keys [j0, j0 + nk) of batch row b's V rows of head h, staged (not
// committed).
template <typename T>
__device__ __forceinline__ void stage_values(const CrossLayout& l, unsigned char* smem,
                                             const T* v, int b, int h, int heads, int head_dim,
                                             int ls, int j0, int nk) {
  const int d_model = heads * head_dim;
  stage_head_rows(reinterpret_cast<T*>(smem + l.off_v), l.v_stride,
                  v + (static_cast<size_t>(b) * ls + j0) * d_model +
                      static_cast<size_t>(h) * head_dim,
                  d_model, nk, round_up(nk, 16), head_dim, head_dim);
}

// Once stage_keys' copies have landed: q * scale rounded to T (as the plain
// version rounds q * Dh^-0.5), then the nk keys' logits with the bias.
template <typename T>
__device__ __forceinline__ void scaled_logits(const CrossLayout& l, unsigned char* smem,
                                              int beams, int head_dim, int nk, float scale) {
  T* q_s = reinterpret_cast<T*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int m = warp; m < beams; m += nwarps) {
    for (int d = lane; d < head_dim; d += 32) {
      T* x = q_s + m * l.q_stride + d;
      *x = from_f32<T>(to_f32(*x) * scale);
    }
  }
  __syncthreads();
  cross_logits(l, q_s, reinterpret_cast<const T*>(smem + l.off_k),
               reinterpret_cast<const float*>(smem + l.off_bias),
               reinterpret_cast<float*>(smem + l.off_s), beams, head_dim, nk, round_up(nk, 16));
  __syncthreads();
}

// P = exp(S - m) / l rounded to T for the nk keys of each beam row, given
// the row's max and sum (m_s, l_s); zero past them and on the pad rows.
template <typename T>
__device__ __forceinline__ void cross_probs(const CrossLayout& l, unsigned char* smem, int beams,
                                            int nk, const float* m_s, const float* l_s) {
  const float* s_s = reinterpret_cast<const float*>(smem + l.off_s);
  T* p_s = reinterpret_cast<T*>(smem + l.off_p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int nk_pad = round_up(nk, 16);
  for (int m = warp; m < l.m_pad; m += nwarps) {
    const float* s = s_s + m * l.s_stride;
    for (int j = lane; j < nk_pad; j += 32) {
      p_s[m * l.p_stride + j] =
          from_f32<T>(m < beams && j < nk ? prob(s[j] - m_s[m], l_s[m]) : 0.f);
    }
  }
}

// Per beam row of the logits: their max and the sum of exp(S - max) over
// the nk keys (held by every lane of the row's warp), by `fn(m, max, sum)`.
template <typename Fn>
__device__ __forceinline__ void row_stats(const CrossLayout& l, const float* s_s, int beams,
                                          int nk, Fn fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int m = warp; m < beams; m += nwarps) {
    const float* s = s_s + m * l.s_stride;
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, s[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) sum += exp_or_zero(s[j] - mx);
    sum = warp_sum(sum);
    fn(m, mx, sum);
  }
}

// One pass (Ls up to the plan's one-pass limit): grid (heads, batch). q, K,
// V and the bias staged together, the exact softmax of each beam's logits,
// P rounded to T, P V.
template <typename T>
__global__ void __launch_bounds__(kCrossThreads) cross_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ out, int beams, int heads, int head_dim,
    int ls, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const CrossLayout l = cross_layout(beams, head_dim, round_up(ls, 16), sizeof(T), true, true, 0);
  float* o_s = reinterpret_cast<float*>(smem + l.off_o);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int d_model = heads * head_dim;

  stage_keys(l, smem, q, k, bias, b, h, beams, heads, head_dim, ls, 0, ls);
  stage_values(l, smem, v, b, h, heads, head_dim, ls, 0, ls);
  cp_async_commit();
  for (int i = tid; i < l.m_pad * head_dim; i += blockDim.x) o_s[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  scaled_logits<T>(l, smem, beams, head_dim, ls, scale);
  // Each warp's rows: the max and sum, then P, rounded to T.
  const int nk_pad = round_up(ls, 16);
  for (int m = warp; m < l.m_pad; m += nwarps) {
    const float* s = reinterpret_cast<const float*>(smem + l.off_s) + m * l.s_stride;
    T* p = reinterpret_cast<T*>(smem + l.off_p) + m * l.p_stride;
    if (m >= beams) {
      for (int j = lane; j < nk_pad; j += 32) p[j] = from_f32<T>(0.f);
      continue;
    }
    float mx = -INFINITY;
    for (int j = lane; j < ls; j += 32) mx = fmaxf(mx, s[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < ls; j += 32) sum += exp_or_zero(s[j] - mx);
    sum = warp_sum(sum);
    for (int j = lane; j < nk_pad; j += 32) {
      p[j] = from_f32<T>(j < ls ? prob(s[j] - mx, sum) : 0.f);
    }
  }
  __syncthreads();
  cross_values(l, reinterpret_cast<const T*>(smem + l.off_p),
               reinterpret_cast<const T*>(smem + l.off_v), o_s, beams, head_dim, ls,
               round_up(ls, 16));
  __syncthreads();
  for (int m = warp; m < beams; m += nwarps) {
    T* o = out + (static_cast<size_t>(b) * beams + m) * d_model + static_cast<size_t>(h) * head_dim;
    for (int d = lane; d < head_dim; d += 32) o[d] = from_f32<T>(o_s[m * head_dim + d]);
  }
}

// The split form, launch 1 of 2: grid (tiles, heads, batch), block (t, h, b)
// takes tile t (keys [t * tile_keys, ...)) of (b, h): its logits, then per
// beam their max and sum of exp(S - max) into the workspace (and, with
// the logits themselves). Block (0, h, b) resets (b, h)'s ticket.
template <typename T>
__global__ void __launch_bounds__(kCrossThreads) cross_stats_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ bias,
    unsigned char* __restrict__ ws, int beams, int head_dim, int ls, int tile_keys, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tiles = gridDim.x, heads = gridDim.y;
  const CrossLayout l = cross_layout(beams, head_dim, tile_keys, sizeof(T), true, false, 0);
  const CrossWorkspace w =
      cross_workspace(gridDim.z, beams, heads, head_dim, tiles, tile_keys);
  const size_t pair = static_cast<size_t>(b) * heads + h;
  const size_t row0 = (pair * tiles + t) * beams;   // workspace row of beam 0
  const int j0 = t * tile_keys;
  const int nk = imin(tile_keys, ls - j0);
  const int lane = threadIdx.x & 31;
  const float* s_s = reinterpret_cast<const float*>(smem + l.off_s);

  stage_keys(l, smem, q, k, bias, b, h, beams, heads, head_dim, ls, j0, nk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  scaled_logits<T>(l, smem, beams, head_dim, nk, scale);
  float2* stats = reinterpret_cast<float2*>(ws + w.off_stats) + row0;
  float* logits = reinterpret_cast<float*>(ws + w.off_logits) + row0 * tile_keys;
  row_stats(l, s_s, beams, nk, [&](int m, float mx, float sum) {
    if (lane == 0) stats[m] = make_float2(mx, sum);
    for (int j = lane; j < nk; j += 32) {
      logits[static_cast<size_t>(m) * tile_keys + j] = s_s[m * l.s_stride + j];
    }
  });
  if (t == 0 && threadIdx.x == 0) reinterpret_cast<unsigned*>(ws)[pair] = 0u;
}

// The split form, launch 2 of 2: grid and tiles as cross_stats_kernel. Every
// block first folds all tiles' stats into each beam's row max m and sum l
// (the same fixed order in every block) and marks live the tiles whose
// largest logit lies within kSkipLogit of some beam's m; the others hold
// only keys whose exp(S - m) is exactly 0 in fp32, and their blocks read
// nothing. A live block reads its logits back from the workspace, forms P =
// exp(S - m) / l rounded to T, and writes its fp32 P V partial (its V rows
// are the only rows of the encoder it reads); the last block of (b, h) to
// take a ticket
// adds the live tiles' partials in tile order (so that two calls are
// bit-equal) and writes the output.
template <typename T>
__global__ void __launch_bounds__(kCrossThreads) cross_value_kernel(
    const T* __restrict__ v, T* __restrict__ out, unsigned char* __restrict__ ws, int beams,
    int head_dim, int ls, int tile_keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tiles = gridDim.x, heads = gridDim.y;
  const CrossLayout l = cross_layout(beams, head_dim, tile_keys, sizeof(T), false, true, tiles);
  const CrossWorkspace w = cross_workspace(gridDim.z, beams, heads, head_dim, tiles, tile_keys);
  const size_t pair = static_cast<size_t>(b) * heads + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  float* s_s = reinterpret_cast<float*>(smem + l.off_s);
  float* o_s = reinterpret_cast<float*>(smem + l.off_o);
  float* m_s = reinterpret_cast<float*>(smem + l.off_stat);
  float* l_s = m_s + l.m_pad;
  int* live_s = reinterpret_cast<int*>(smem + l.off_live);
  int* last_s = live_s + tiles;
  float* part = reinterpret_cast<float*>(ws + w.off_part) + pair * tiles * beams * head_dim;

  for (int i = tid; i < tiles; i += blockDim.x) live_s[i] = 0;
  __syncthreads();
  const float2* stats =
      reinterpret_cast<const float2*>(ws + w.off_stats) + pair * tiles * beams;
  for (int m = warp; m < beams; m += nwarps) {
    float mx = -INFINITY;
    for (int i = lane; i < tiles; i += 32) mx = fmaxf(mx, stats[i * beams + m].x);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < tiles; i += 32) {
      const float2 st = stats[i * beams + m];
      sum += st.y * expf(st.x - mx);
      if (!(st.x < mx - kSkipLogit)) live_s[i] = 1;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[m] = mx;
      l_s[m] = sum;
    }
  }
  __syncthreads();

  if (live_s[t]) {
    const int j0 = t * tile_keys;
    const int nk = imin(tile_keys, ls - j0);
    const float* logits = reinterpret_cast<const float*>(ws + w.off_logits) +
                          (pair * tiles + t) * beams * tile_keys;
    // One 16-byte piece of every step-th beam's row per thread (the
    // workspace rows hold tile_keys floats; pieces past nk are not read).
    const int pieces = (nk + 3) / 4;
    const int step = blockDim.x / (tile_keys / 4);
    const int m0 = tid / (tile_keys / 4), c = 4 * (tid - m0 * (tile_keys / 4));
    for (int m = m0; m0 < step && c < 4 * pieces && m < beams; m += step) {
      cp_async<16>(s_s + m * l.s_stride + c, logits + static_cast<size_t>(m) * tile_keys + c);
    }
    cp_async_commit();
    stage_values(l, smem, v, b, h, heads, head_dim, ls, j0, nk);
    cp_async_commit();
    for (int i = tid; i < l.m_pad * head_dim; i += blockDim.x) o_s[i] = 0.f;
    cp_async_wait<1>();
    __syncthreads();
    cross_probs<T>(l, smem, beams, nk, m_s, l_s);
    cp_async_wait<0>();
    __syncthreads();
    cross_values(l, reinterpret_cast<const T*>(smem + l.off_p),
                 reinterpret_cast<const T*>(smem + l.off_v), o_s, beams, head_dim, nk,
                 round_up(nk, 16));
    __syncthreads();
    float* mine = part + static_cast<size_t>(t) * beams * head_dim;
    for (int i = tid; i < beams * head_dim; i += blockDim.x) mine[i] = o_s[i];
  }

  __threadfence();
  __syncthreads();
  if (tid == 0) {
    *last_s = atomicAdd(reinterpret_cast<unsigned*>(ws) + pair, 1u) ==
              static_cast<unsigned>(tiles - 1);
  }
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  const int d_model = heads * head_dim;
  for (int i = tid; i < beams * head_dim; i += blockDim.x) {
    const int m = i / head_dim, d = i - m * head_dim;
    float o = 0.f;
    for (int j = 0; j < tiles; ++j) {
      if (live_s[j]) o += __ldcg(part + static_cast<size_t>(j) * beams * head_dim + i);
    }
    out[(static_cast<size_t>(b) * beams + m) * d_model + static_cast<size_t>(h) * head_dim + d] =
        from_f32<T>(o);
  }
}

// Four consecutive outputs, rounded to bf16.
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 o) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(o.x, o.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(o.z, o.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = raw;
}

// The cluster barrier in two halves: a relaxed arrival (it orders no
// memory) and the wait for every thread of the cluster to have arrived.
// A block may write into a peer's shared memory only once the peer has
// started; an arrival at entry and the wait before the first such write
// say so at the cost of the wait alone.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The cluster form (bf16, head_dim kClusterDh, up to 16 * kMt beams): grid
// (tiles, heads, batch) in clusters of (tiles, 1, 1), so that the blocks of
// one cluster are the tiles of one (b, h), block t (rank t) taking keys
// [t * tile_keys, ...), and each of its warps 32 of them.
// S, P and the P V partial stay in the warp's mma fragments (S's m16n8
// accumulators of two key tiles are P's m16k16 operand), so a warp's chain
// is its products and its rows' quad reductions; only each (warp, beam)'s
// max and sum and the warps' partials cross shared memory, and through it
// the cluster.
template <int kMt>
__global__ void __launch_bounds__(kClusterMaxWarps * 32, 3) cluster_cross_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int beams, int ls, float scale) {
  constexpr int kDh = kClusterDh, kStride = kDh + 8, kMPad = 16 * kMt;
  constexpr int kNt = kClusterWarpKeys / 8, kKt = kDh / 16, kOt = kDh / 8;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tiles = gridDim.x, d_model = gridDim.y * kDh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, gc = lane & 3;
  const int warps = blockDim.x >> 5, tile_keys = warps * kClusterWarpKeys;
  const ClusterLayout l = cluster_layout(beams, tiles, warps);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + l.off_k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + l.off_v);
  float* bias_s = reinterpret_cast<float*>(smem + l.off_bias);
  float2* stats = reinterpret_cast<float2*>(smem + l.off_stat);   // (rank, warp, beam)
  float2* ml = reinterpret_cast<float2*>(smem + l.off_ml);        // (beam): m, l
  float* parts = reinterpret_cast<float*>(smem + l.off_k);   // (rank, put, slice, kDh)
  const int j0 = t * tile_keys;
  const int nk = imin(tile_keys, ls - j0);
  const int key0 = warp * kClusterWarpKeys;
  const bool live = key0 < nk;
  const size_t head_off = static_cast<size_t>(h) * kDh;
  cluster_arrive_relaxed();   // this block has started; waited for before the first put

  // 1. q, the K rows and the bias (group 0); the V rows, zero past the
  // tile's keys (group 1).
  const size_t rows0 = (static_cast<size_t>(b) * ls + j0) * d_model + head_off;
  stage_head_rows(q_s, kStride, q + static_cast<size_t>(b) * beams * d_model + head_off, d_model,
                  beams, kMPad, kDh, kDh);
  stage_head_rows(k_s, kStride, k + rows0, d_model, nk, nk, kDh, kDh);
  for (int j = tid; j < nk; j += blockDim.x) {
    cp_async<4>(bias_s + j, bias + static_cast<size_t>(b) * ls + j0 + j);
  }
  cp_async_commit();
  stage_head_rows(v_s, kStride, v + rows0, d_model, nk, tile_keys, kDh, kDh);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // 2. q * scale rounded to bf16 (as the plain version rounds q * Dh^-0.5),
  // two elements a thread.
  for (int i = tid; i < beams * kDh / 2; i += blockDim.x) {
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(q_s + (2 * i / kDh) * kStride) +
                        i % (kDh / 2);
    const float2 x = __bfloat1622float2(*e);
    *e = __floats2bfloat162_rn(x.x * scale, x.y * scale);
  }
  __syncthreads();

  // 3. S = q K^T + bias over the warp's keys (-inf past the tile's); per
  // beam row (each thread holds rows gr and gr + 8 of each 16-row tile)
  // their max mx and e = exp(S - mx), which s then holds, and the sum of e.
  float s[kMt][kNt][4], row_mx[kMt][2], row_sum[kMt][2];
  if (live) {
    uint32_t a[kMt][kKt][4];
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
      for (int kk = 0; kk < kKt; ++kk) {
        ldsm_x4(a[mt][kk], q_s + (mt * 16 + a_row) * kStride + kk * 16 + a_col);
      }
    }
    const int b_row = lane & 7, b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      uint32_t bk[kKt][2];
#pragma unroll
      for (int kk = 0; kk < kKt; ++kk) {
        ldsm_x2(bk[kk], k_s + (key0 + nt * 8 + b_row) * kStride + kk * 16 + b_col);
      }
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        float* c = s[mt][nt];
        c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kKt; ++kk) {
          mma_bf16(c, a[mt][kk][0], a[mt][kk][1], a[mt][kk][2], a[mt][kk][3], bk[kk][0],
                   bk[kk][1]);
        }
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const int j = key0 + nt * 8 + 2 * gc;
    const float2 bj = *reinterpret_cast<const float2*>(bias_s + j);   // past nk: not used
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
      float* c = s[mt][nt];
      c[0] = live && j < nk ? c[0] + bj.x : -INFINITY;
      c[1] = live && j + 1 < nk ? c[1] + bj.y : -INFINITY;
      c[2] = live && j < nk ? c[2] + bj.x : -INFINITY;
      c[3] = live && j + 1 < nk ? c[3] + bj.y : -INFINITY;
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        mx = fmaxf(mx, fmaxf(s[mt][nt][2 * half], s[mt][nt][2 * half + 1]));
      }
      mx = quad_max(mx);
      const float shift = mx == -INFINITY ? 0.f : mx;   // e 0 where every key is past the tile
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        float* c = s[mt][nt] + 2 * half;
        c[0] = exp_or_zero(c[0] - shift);
        c[1] = exp_or_zero(c[1] - shift);
        sum += c[0] + c[1];
      }
      row_mx[mt][half] = mx;
      row_sum[mt][half] = quad_sum(sum);
    }
  }
  // Each (warp, beam)'s max and sum into every rank's shared memory, once
  // every block of the cluster has started (the wait for the arrival made
  // at entry, which the staging and the products above have hidden).
  cluster_wait();
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + half * 8 + gr;
      if (gc == 0 && m < beams) {
        for (int r = 0; r < tiles; ++r) {
          cluster.map_shared_rank(stats, r)[(t * warps + warp) * kMPad + m] =
              make_float2(row_mx[mt][half], row_sum[mt][half]);
        }
      }
    }
  }
  cluster.sync();

  // 4. Each beam's m and l from every (rank, warp) pair, one warp a beam,
  // one lane a pair: the same order, and so the same bits, in every block.
  for (int m = warp; m < beams; m += warps) {
    const float2 st = lane < tiles * warps ? stats[lane * kMPad + m]
                                                   : make_float2(-INFINITY, 0.f);
    const float row_m = warp_max(st.x);
    const float row_l = warp_sum(lane < tiles * warps ? st.y * expf(st.x - row_m) : 0.f);
    if (lane == 0) ml[m] = make_float2(row_m, row_l);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 5. P = e exp(mx - m) / l (exp(S - m) / l up to fp32 rounding; the head
  // note) rounded to bf16, straight into the A operand, and the warp's fp32
  // P V over its keys.
  float o[kMt][kOt][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int ot = 0; ot < kOt; ++ot) o[mt][ot][0] = o[mt][ot][1] = o[mt][ot][2] = o[mt][ot][3] = 0.f;
  }
  if (live) {
    float scale_p[kMt][2];   // exp(mx - m) / l per row; 0 on the pad rows
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + half * 8 + gr;
        const float2 x = m < beams ? ml[m] : make_float2(0.f, 1.f);
        scale_p[mt][half] = m < beams ? expf(row_mx[mt][half] - x.x) / x.y : 0.f;
      }
    }
    const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < kNt / 2; ++ks) {
      uint32_t pa[kMt][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        const float* s0 = s[mt][2 * ks];
        const float* s1 = s[mt][2 * ks + 1];
        const float c0 = scale_p[mt][0], c1 = scale_p[mt][1];
        pa[mt][0] = pack_bf16(s0[0] * c0, s0[1] * c0);
        pa[mt][1] = pack_bf16(s0[2] * c1, s0[3] * c1);
        pa[mt][2] = pack_bf16(s1[0] * c0, s1[1] * c0);
        pa[mt][3] = pack_bf16(s1[2] * c1, s1[3] * c1);
      }
#pragma unroll
      for (int ot = 0; ot < kOt; ++ot) {
        uint32_t bv[2];
        ldsm_x2_trans(bv, v_s + (key0 + ks * 16 + v_row) * kStride + ot * 8);
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
          mma_bf16(o[mt][ot], pa[mt][0], pa[mt][1], pa[mt][2], pa[mt][3], bv[0], bv[1]);
        }
      }
    }
  }
  // 6. The warp's partial of each beam row (with two 16-row tiles, warps 2
  // and 3 first add theirs to warps 0 and 1's, through the V rows' room)
  // into the shared memory of the rank that adds that row (rank m / slice).
  const int puts = cluster_puts(kMt, warps);
  if constexpr (kMt > 1) {
    __syncthreads();   // every warp is done with the V rows
    float2* pass = reinterpret_cast<float2*>(v_s) + (warp % puts) * kMt * 2 * kOt * 32 + lane;
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      if (warp / puts == 1 - round) {
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int ot = 0; ot < kOt; ++ot) {
              float2* x = pass + ((mt * 2 + half) * kOt + ot) * 32;
              if (round == 0) {
                *x = make_float2(o[mt][ot][2 * half], o[mt][ot][2 * half + 1]);
              } else {
                o[mt][ot][2 * half] += x->x;
                o[mt][ot][2 * half + 1] += x->y;
              }
            }
          }
        }
      }
      if (round == 0) __syncthreads();
    }
  }
  const int slice_size = l.slice * kDh;
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + half * 8 + gr;
      if (warp < puts && m < beams) {   // a warp without keys puts zeros
        const int r = m / l.slice;
        float* dst = cluster.map_shared_rank(parts, r) +
                     (t * puts + warp) * slice_size + (m - r * l.slice) * kDh + 2 * gc;
#pragma unroll
        for (int ot = 0; ot < kOt; ++ot) {
          *reinterpret_cast<float2*>(dst + ot * 8) =
              make_float2(o[mt][ot][2 * half], o[mt][ot][2 * half + 1]);
        }
      }
    }
  }
  cluster.sync();

  // 7. This rank's rows of the outputs: the (rank, put) partials added in
  // order, four outputs a thread.
  const int first = t * l.slice * kDh / 4;
  const int end = imin(beams, (t + 1) * l.slice) * kDh / 4;
  __nv_bfloat16* out_bh = out + static_cast<size_t>(b) * beams * d_model + head_off;
  const float4* mine = reinterpret_cast<const float4*>(parts);
  for (int i = first + tid; i < end; i += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < tiles * puts; ++p) {
      const float4 x = mine[p * slice_size / 4 + i - first];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int m = 4 * i / kDh;
    store4(out_bh + static_cast<size_t>(m) * d_model + (4 * i - m * kDh), acc);
  }
}

// The cluster barrier's other half: an arrival that releases this thread's
// writes. And a named barrier of `count` threads of the block.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The bits of a rank's live mask that belong to consumer warp w: chunks w,
// w + warps, ...
__device__ __forceinline__ unsigned stream_warp_bits(int w, int warps) {
  unsigned bits = 0u;
  for (int j = w; j < 32; j += warps) bits |= 1u << j;
  return bits;
}

// The stream form (bf16, head_dim kClusterDh, 1025 to kStreamKeys keys):
// grid (ranks, heads, batch x halves) in clusters of (ranks, 1, 1), so that
// the blocks of one cluster are the ranks of one (b, h) and one 16-row half
// of its beams (a second half, past 16 beams, reads the same K and V rows,
// from L2 where its cluster runs beside the first's).
// Rank t takes the chunks of kStreamChunkKeys keys t, t + ranks, t + 2
// ranks, ..., so that every rank holds about as many of a row's valid keys
// as the others, and its j-th chunk goes to consumer warp j % warps. The
// block's last warp loads: one lane streams the rank's K chunks, then its
// live V chunks, in chunk order, as TMA boxes of the (batch, Ls, D) K and V
// maps into the consumer warps' rings. A consumer warp keeps each chunk's
// S in its mma fragments until that chunk's P V. Three blocks share an SM.
__global__ void __launch_bounds__((kStreamMaxWarps + 1) * 32, 3)
    stream_cross_attention_kernel(const __grid_constant__ CUtensorMap k_map,
                                  const __grid_constant__ CUtensorMap v_map,
                                  const __nv_bfloat16* __restrict__ q,
                                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                                  int beams, int ls, float scale) {
  constexpr int kDh = kClusterDh, kC = kStreamWarpChunks;
  constexpr int kNt = kStreamChunkKeys / 8, kKt = kDh / 16, kOt = kDh / 8;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int halves = (beams + 15) / 16;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z / halves;
  const int row0 = (blockIdx.z - b * halves) * 16;   // this block's first beam
  const int rows = imin(16, beams - row0);           // and its beams
  const int ranks = gridDim.x, d_model = gridDim.y * kDh;
  const int warps = (blockDim.x >> 5) - 1;   // consumer warps; the last warp loads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gr = lane >> 2, gc = lane & 3;
  const StreamLayout l = stream_layout(rows, ranks, warps);
  float2* stats = reinterpret_cast<float2*>(smem + l.off_stat);   // (rank, warp, beam)
  float2* ml = reinterpret_cast<float2*>(smem + l.off_ml);        // (beam): m, l
  float* wmax = reinterpret_cast<float*>(smem + l.off_wmax);      // (warp, beam)
  float* parts = reinterpret_cast<float*>(smem + l.off_part);     // (rank, warp, slice, kDh)
  unsigned* live_mask = reinterpret_cast<unsigned*>(smem + l.off_mask);
  // Warp w's n-th chunk (its K chunks, then its live V chunks) lands in
  // stage n % kStreamWarpStages of its ring: one loader lane and one warp
  // take each ring in order, so a wait is never more than a phase ahead.
  const int stages = warps * kStreamWarpStages;
  const uint32_t bars = smem_u32(smem + l.off_bar);
  auto stage = [&](int w, int n) { return w * kStreamWarpStages + n % kStreamWarpStages; };
  auto tile_of = [&](int w, int n) { return smem + stage(w, n) * kStreamChunkBytes; };
  auto full = [&](int w, int n) { return bars + 8 * stage(w, n); };
  auto empty = [&](int w, int n) { return bars + 8 * (stages + stage(w, n)); };
  auto parity = [](int n) { return (n / kStreamWarpStages) & 1; };
  // The rank's chunks j = 0 .. chunks - 1, keys chunk_key(j) ...; chunk j
  // goes to consumer warp j % warps.
  const int all_chunks = (ls + kStreamChunkKeys - 1) / kStreamChunkKeys;
  const int chunks = (all_chunks - t + ranks - 1) / ranks;
  auto chunk_key = [&](int j) { return (t + j * ranks) * kStreamChunkKeys; };
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(bars + 8 * st, 1);
      mbar_init(bars + 8 * (stages + st), 1);
    }
    *live_mask = 0u;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive_relaxed();   // this block has started; waited for before the first put

  if (warp == warps) {
    // The loads, one lane, in chunk order: chunk j into consumer warp (j %
    // warps)'s ring as that warp's n-th chunk; the K chunks, then (once the
    // rank's live mask is made) the live V chunks.
    auto load = [&](const CUtensorMap* map, int j, int n) {
      const int w = j % warps;
      mbar_wait(empty(w, n), parity(n) ^ 1);
      mbar_expect_tx(full(w, n), kStreamChunkBytes);
      tma_load_3d(smem_u32(tile_of(w, n)), map, h * kDh, chunk_key(j), b, full(w, n));
    };
    if (lane == 0) {
      for (int j = 0; j < chunks; ++j) load(&k_map, j, j / warps);
    }
    __syncwarp();
    cluster_wait();
    cluster_arrive();            // this warp puts no stats
    named_sync(1, blockDim.x);   // the rank's live mask is made
    if (lane == 0) {
      const unsigned mask = *live_mask;
      for (int j = 0; j < chunks; ++j) {
        // The warp's K chunks, then its live V chunks before this one.
        const int w = j % warps;
        const unsigned before = mask & ((1u << j) - 1u) & stream_warp_bits(w, warps);
        if ((mask >> j) & 1u) load(&v_map, j, (chunks - w + warps - 1) / warps + __popc(before));
      }
    }
    __syncwarp();
    cluster_wait();
    cluster_arrive();
    cluster_wait();              // every rank's partials are in
  } else {
    // 1. q * scale rounded to bf16 (as the plain version rounds q *
    // Dh^-0.5), straight into the A fragments; 0 on the pad rows.
    const __nv_bfloat16* q_bh =
        q + (static_cast<size_t>(b) * beams + row0) * d_model + h * kDh;
    auto q_pair = [&](int m, int c) -> uint32_t {
      if (m >= rows) return 0u;
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(q_bh + static_cast<size_t>(m) * d_model + c));
      return pack_bf16(x.x * scale, x.y * scale);
    };
    uint32_t a[kKt][4];
#pragma unroll
    for (int kk = 0; kk < kKt; ++kk) {
      const int c = kk * 16 + 2 * gc;
      a[kk][0] = q_pair(gr, c);
      a[kk][1] = q_pair(gr + 8, c);
      a[kk][2] = q_pair(gr, c + 8);
      a[kk][3] = q_pair(gr + 8, c + 8);
    }

    // 2. S = q K^T + bias for each of the warp's chunks (-inf past Ls, and
    // on a chunk past the rank's), and each chunk's max per beam row (each
    // thread holds rows gr and gr + 8: half 0 and 1). A lane reads the bias
    // of one key of the next chunk while this one computes.
    const float* bias_b = bias + static_cast<size_t>(b) * ls;
    auto bias_of = [&](int j) {
      const int key = j < chunks ? chunk_key(j) + lane : ls;
      return key < ls ? bias_b[key] : -INFINITY;
    };
    float s[kC][kNt][4], cmx[kC][2];
    float b_next = bias_of(warp);
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int j = i * warps + warp;
      const float b_lane = b_next;
      if (i + 1 < kC) b_next = bias_of(j + warps);
      if (j < chunks) {
        mbar_wait(full(warp, i), parity(i));
        const unsigned char* tile = tile_of(warp, i);
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          // Keys nt * 8 + (lane & 7), 16-byte pieces 4 * half + (lane >> 3)
          // of their rows; piece p of row r sits at p ^ (r & 7) (the swizzle).
          uint32_t bk[kKt][2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t r[4];
            ldsm_x4(r, reinterpret_cast<const __nv_bfloat16*>(
                           tile + (nt * 8 + (lane & 7)) * 128 +
                           (((4 * half + (lane >> 3)) ^ (lane & 7)) << 4)));
            bk[2 * half][0] = r[0];
            bk[2 * half][1] = r[1];
            bk[2 * half + 1][0] = r[2];
            bk[2 * half + 1][1] = r[3];
          }
          const float b0 = __shfl_sync(kFullMask, b_lane, nt * 8 + 2 * gc);
          const float b1 = __shfl_sync(kFullMask, b_lane, nt * 8 + 2 * gc + 1);
          float* c = s[i][nt];
          c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < kKt; ++kk) {
            mma_bf16(c, a[kk][0], a[kk][1], a[kk][2], a[kk][3], bk[kk][0], bk[kk][1]);
          }
          c[0] += b0;
          c[1] += b1;
          c[2] += b0;
          c[3] += b1;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(warp, i));
      } else {
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) s[i][nt][0] = s[i][nt][1] = s[i][nt][2] = s[i][nt][3] = -INFINITY;
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          mx = fmaxf(mx, fmaxf(s[i][nt][2 * half], s[i][nt][2 * half + 1]));
        }
        cmx[i][half] = quad_max(mx);
      }
    }

    // 3. The warp's max of each beam row, and from every warp's the rank's.
    // A chunk where some beam's largest logit lies within kSkipLogit of the
    // rank's max is live here: its V rows load while the cluster folds
    // every rank's stats. A chunk dead here is dead for the row's m too (m
    // is at least the rank's max), and a chunk live here but not for m adds
    // exactly 0.
    float wmx[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kC; ++i) mx = fmaxf(mx, cmx[i][half]);
      wmx[half] = mx;
      if (gc == 0) wmax[warp * 16 + half * 8 + gr] = mx;
    }
    named_sync(2, warps * 32);
    {
      float rmx[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = half * 8 + gr;
        float mx = -INFINITY;
        for (int w = 0; w < warps; ++w) mx = fmaxf(mx, wmax[w * 16 + m]);
        rmx[half] = m < rows ? mx : INFINITY;   // a pad row keeps no chunk live
      }
      unsigned mine = 0u;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        const bool live = !(cmx[i][0] < rmx[0] - kSkipLogit) || !(cmx[i][1] < rmx[1] - kSkipLogit);
        const int j = i * warps + warp;
        if (__any_sync(kFullMask, live) && j < chunks) mine |= 1u << j;
      }
      if (lane == 0 && mine) atomicOr(live_mask, mine);
    }
    named_sync(1, blockDim.x);   // the loading warp reads the live mask
    const unsigned mask = *live_mask;

    // 4. Per beam row, the sum of exp(S - mx) over the warp's keys (a chunk
    // whose row max lies more than kSkipLogit below mx adds exactly 0), and
    // (mx, sum) into every rank's shared memory, once every block of the
    // cluster has started (the wait for the arrival made at entry).
    cluster_wait();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = half * 8 + gr;
      const float mx = wmx[half];
      const float shift = mx == -INFINITY ? 0.f : mx;   // no key: the sum is 0
      float sum = 0.f;
      if (m < rows) {
#pragma unroll
        for (int i = 0; i < kC; ++i) {
          if (cmx[i][half] < shift - kSkipLogit) continue;
#pragma unroll
          for (int nt = 0; nt < kNt; ++nt) {
            sum += exp_or_zero(s[i][nt][2 * half] - shift) +
                   exp_or_zero(s[i][nt][2 * half + 1] - shift);
          }
        }
      }
      sum = quad_sum(sum);
      if (gc == 0 && m < rows) {
        for (int r = 0; r < ranks; ++r) {
          cluster.map_shared_rank(stats, r)[(t * warps + warp) * 16 + m] = make_float2(mx, sum);
        }
      }
    }
    cluster_arrive();
    cluster_wait();

    // 5. Each beam's m and l from every (rank, warp) pair, one warp a beam,
    // one pair a lane: the same order, and so the same bits, in every
    // block.
    const int pairs = ranks * warps;
    for (int m = warp; m < rows; m += warps) {
      const float2 st = lane < pairs ? stats[lane * 16 + m] : make_float2(-INFINITY, 0.f);
      const float row_m = warp_max(st.x);
      const float row_l = warp_sum(lane < pairs ? st.y * expf(st.x - row_m) : 0.f);
      if (lane == 0) ml[m] = make_float2(row_m, row_l);
    }
    named_sync(2, warps * 32);
    float row_m[2], row_l[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = half * 8 + gr;
      const float2 x = m < rows ? ml[m] : make_float2(INFINITY, 1.f);   // pad rows: P 0
      row_m[half] = x.x;
      row_l[half] = x.y;
    }

    // 6. P = exp(S - m) / l rounded to bf16, straight into the A operand
    // (S's m16n8 accumulators of two key tiles are P's m16k16 operand; a
    // row whose chunk max lies more than kSkipLogit below m has P 0 there),
    // and the warp's fp32 P V over its live chunks, its n-th chunks from n =
    // its K chunks on.
    float o[kOt][4];
#pragma unroll
    for (int ot = 0; ot < kOt; ++ot) o[ot][0] = o[ot][1] = o[ot][2] = o[ot][3] = 0.f;
    int n = (chunks - warp + warps - 1) / warps;
#pragma unroll
    for (int i = 0; i < kC; ++i) {
      const int j = i * warps + warp;
      if (j >= chunks || !((mask >> j) & 1u)) continue;
      bool rows_live[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        rows_live[half] = !(cmx[i][half] < row_m[half] - kSkipLogit);
      }
      mbar_wait(full(warp, n), parity(n));
      if (__any_sync(kFullMask, rows_live[0] || rows_live[1])) {
        const unsigned char* tile = tile_of(warp, n);
#pragma unroll
        for (int ks = 0; ks < kNt / 2; ++ks) {
          uint32_t pa[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* s0 = s[i][2 * ks] + 2 * half;
            const float* s1 = s[i][2 * ks + 1] + 2 * half;
            const float mr = row_m[half], lr = row_l[half];
            auto p = [&](float x) { return prob(x - mr, lr); };
            if (rows_live[half]) {
              pa[half] = pack_bf16(p(s0[0]), p(s0[1]));
              pa[2 + half] = pack_bf16(p(s1[0]), p(s1[1]));
            } else {
              pa[half] = pa[2 + half] = 0u;
            }
          }
          // V's keys 16 ks + (lane & 7) (+ 8 for lanes 8-15 and 24-31), pieces
          // ot and ot + 1 (lanes 16-31), read transposed into B fragments.
          const int key = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int ot = 0; ot < kOt; ot += 2) {
            uint32_t r[4];
            ldsm_x4_trans(r, reinterpret_cast<const __nv_bfloat16*>(
                                 tile + key * 128 + (((ot + (lane >> 4)) ^ (lane & 7)) << 4)));
            mma_bf16(o[ot], pa[0], pa[1], pa[2], pa[3], r[0], r[1]);
            mma_bf16(o[ot + 1], pa[0], pa[1], pa[2], pa[3], r[2], r[3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(warp, n));
      ++n;
    }

    // 7. The warp's partial of each beam row into the shared memory of the
    // rank that adds that row (rank m / slice); a warp without live chunks
    // puts zeros.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = half * 8 + gr;
      if (m < rows) {
        const int r = m / l.slice;
        float* dst = cluster.map_shared_rank(parts, r) +
                     ((t * warps + warp) * l.slice + (m - r * l.slice)) * kDh + 2 * gc;
#pragma unroll
        for (int ot = 0; ot < kOt; ++ot) {
          *reinterpret_cast<float2*>(dst + ot * 8) =
              make_float2(o[ot][2 * half], o[ot][2 * half + 1]);
        }
      }
    }
    cluster_arrive();
    cluster_wait();
  }

  // 8. This rank's rows of the outputs: the (rank, warp) partials added in
  // order (two calls are bit-equal), four outputs a thread.
  const int first = t * l.slice * kDh / 4;
  const int end = imin(rows, (t + 1) * l.slice) * kDh / 4;
  const int pairs = ranks * warps;
  __nv_bfloat16* out_bh = out + (static_cast<size_t>(b) * beams + row0) * d_model + h * kDh;
  const float4* mine = reinterpret_cast<const float4*>(parts);
  for (int i = first + tid; i < end; i += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < pairs; ++p) {
      const float4 x = mine[p * l.slice * kDh / 4 + i - first];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int m = 4 * i / kDh;
    store4(out_bh + static_cast<size_t>(m) * d_model + (4 * i - m * kDh), acc);
  }
}

// Raise a kernel's dynamic shared-memory limit once it needs more than the
// default 48 KB (once per size it grows to, not per launch).
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes, size_t* reserved) {
  if (bytes <= kDefaultSmem || bytes <= *reserved) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *reserved = bytes;
  return err;
}

// The select kernel's plan for a stage of `length` times: in shared memory,
// or with the per-time tables spilled when they do not fit.
template <typename T, typename TNew, bool kUpdate>
SelectLayout select_plan(int beams, int head_dim, int length) {
  constexpr bool kQuantized = std::is_same<T, int8_t>::value;
  const SelectLayout lay = select_layout(beams, head_dim, length, sizeof(T), sizeof(TNew),
                                         kQuantized, kUpdate, false);
  if (lay.total <= kMaxSmem) return lay;
  return select_layout(beams, head_dim, length, sizeof(T), sizeof(TNew), kQuantized, kUpdate,
                       true);
}

bool select_shape_ok(int beams, int head_dim, int length) {
  // The staged-row tables are 16-bit: at most 65536 (time, slot) rows.
  return head_dim <= kMaxHeadDim && head_dim % 8 == 0 && beams >= 1 && beams <= 256 &&
         length >= 1 && static_cast<long long>(length) * beams <= 65536;
}

template <typename T, typename TNew, bool kUpdate>
int launch_select(const void* q, const void* k_new, const void* v_new, void* cache,
                  void* scales, const void* ancestry, void* out, void* workspace, int batch,
                  int beams, int heads, int head_dim, int flat, int flat_pad,
                  int anc_row_stride, const int* pos, int length, float scale, cudaStream_t s) {
  if (!select_shape_ok(beams, head_dim, length)) return static_cast<int>(cudaErrorInvalidValue);
  const SelectLayout lay = select_plan<T, TNew, kUpdate>(beams, head_dim, length);
  if (lay.total > kMaxSmem || (lay.spill && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool three = 3 * (lay.total + 1024) <= kSmemPerSm;   // 1 KB reserved per block
  auto kernel = three ? select_attention_kernel<T, TNew, kUpdate, 3>
                      : select_attention_kernel<T, TNew, kUpdate, 2>;
  static size_t reserved[2] = {0, 0};
  const cudaError_t err = reserve_smem(kernel, lay.total, &reserved[three]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(heads, batch), kSelectThreads, lay.total, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const TNew*>(k_new),
      static_cast<const TNew*>(v_new), static_cast<T*>(cache), static_cast<float*>(scales),
      static_cast<const int*>(ancestry), static_cast<__nv_bfloat16*>(out),
      lay.spill ? static_cast<unsigned char*>(workspace) : nullptr, batch, beams, heads,
      head_dim, flat, flat_pad, anc_row_stride, pos, length, lay.spill, scale);
  return static_cast<int>(cudaGetLastError());
}

// The cross plan: an encoder of up to kCrossOnePassKeys keys (rounded to
// 16) whose block fits shared memory takes the one-pass form; a longer one
// of up to kClusterKeys keys in bf16 at head_dim kClusterDh and up to 32
// beams the cluster form, in tiles of 32 keys a warp; in bf16 at that head
// size and beams, one of up to kStreamKeys keys the stream form, tile_keys
// keys a rank (the fewest ranks of kStreamMaxWarps consumer warps, their
// chunks spread evenly, in 16-row halves of the beams); any other the split form, in tiles of
// kCrossTileKeys keys (halved while a block would pass kMaxSmem), a block
// each. tile_keys is -1 for a shape the kernels do not take; workspace is
// 0 but for the split form.
enum CrossForm { kOnePass = 0, kCluster = 1, kSplit = 2, kStream = 3 };

// The stream form's consumer warps a rank for its plan's tile_keys.
inline int stream_warps(int tile_keys) {
  return (tile_keys / kStreamChunkKeys + kStreamWarpChunks - 1) / kStreamWarpChunks;
}

struct CrossPlan {
  int form;
  int tile_keys;
  long long workspace;
};

CrossPlan cross_plan(int elt, int batch, int beams, int heads, int head_dim, int ls) {
  CrossPlan p{kOnePass, -1, 0};
  if (head_dim > kMaxHeadDim || head_dim % 8 != 0 || ls < 1 || beams < 1 || beams > 256 ||
      batch < 1 || heads < 1 || batch > 65535 || heads > 65535) {
    return p;
  }
  const int one_pass = round_up(ls, 16);
  if (one_pass <= kCrossOnePassKeys &&
      cross_layout(beams, head_dim, one_pass, elt, true, true, 0).total <= kMaxSmem) {
    p.tile_keys = one_pass;
    return p;
  }
  if (elt == 2 && head_dim == kClusterDh && beams <= 32 && ls <= kClusterKeys) {
    // The least warps in all plus two a rank (its barriers, the fold and
    // its slice's sums cost about two warps' keys, measured at Ls 279),
    // then the fewest warps a block; two 16-row tiles of beams pair warps.
    int warps = 0, tiles = 0;
    for (int w = beams > 16 ? 2 : 1; w <= kClusterMaxWarps; w += beams > 16 ? 2 : 1) {
      const int n = (ls + w * kClusterWarpKeys - 1) / (w * kClusterWarpKeys);
      if (n <= kClusterTiles && n * w <= 32 &&
          (!warps || n * (w + 2) < tiles * (warps + 2))) {
        warps = w;
        tiles = n;
      }
    }
    if (warps && cluster_layout(beams, tiles, warps).total <= kMaxSmem) {
      p.form = kCluster;
      p.tile_keys = warps * kClusterWarpKeys;
      return p;
    }
  }
  if (elt == 2 && head_dim == kClusterDh && beams <= 32 && ls > kClusterKeys &&
      ls <= kStreamKeys && static_cast<long long>(batch) * ((beams + 15) / 16) <= 65535) {
    const int chunks = (ls + kStreamChunkKeys - 1) / kStreamChunkKeys;
    const int per_rank = kStreamMaxWarps * kStreamWarpChunks;
    const int ranks = (chunks + per_rank - 1) / per_rank;
    const int tile_keys = (chunks + ranks - 1) / ranks * kStreamChunkKeys;
    if (ranks <= kStreamMaxRanks &&
        stream_layout(16, (ls + tile_keys - 1) / tile_keys, stream_warps(tile_keys)).total <=
            kMaxSmem) {
      p.form = kStream;
      p.tile_keys = tile_keys;
      return p;
    }
  }
  for (int tile = kCrossTileKeys; tile >= 16; tile /= 2) {
    const int tiles = (ls + tile - 1) / tile;
    if (cross_layout(beams, head_dim, tile, elt, true, false, 0).total <= kMaxSmem &&
        cross_layout(beams, head_dim, tile, elt, false, true, tiles).total <= kMaxSmem) {
      p.form = kSplit;
      p.tile_keys = tile;
      p.workspace = static_cast<long long>(
          cross_workspace(batch, beams, heads, head_dim, tiles, tile).total);
      return p;
    }
  }
  return p;
}

template <typename T>
int launch_cross(const void* q, const void* k, const void* v, const void* bias, void* out,
                 void* workspace, long long workspace_bytes, int batch, int beams, int heads,
                 int head_dim, int ls, float scale, cudaStream_t s) {
  const CrossPlan plan = cross_plan(sizeof(T), batch, beams, heads, head_dim, ls);
  if (plan.tile_keys < 0 || workspace_bytes < plan.workspace ||
      (plan.workspace > 0 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Half the threads where the beams fill one 16-row tile: more blocks then
  // share an SM.
  const int threads = beams <= 16 ? kCrossThreads / 2 : kCrossThreads;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* bt = static_cast<const float*>(bias);
  if (plan.form == kOnePass) {
    const size_t smem =
        cross_layout(beams, head_dim, round_up(ls, 16), sizeof(T), true, true, 0).total;
    static size_t reserved = 0;
    const cudaError_t err = reserve_smem(cross_attention_kernel<T>, smem, &reserved);
    if (err != cudaSuccess) return static_cast<int>(err);
    cross_attention_kernel<T><<<dim3(heads, batch), threads, smem, s>>>(
        qt, kt, vt, bt, static_cast<T*>(out), beams, heads, head_dim, ls, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int tile_keys = plan.tile_keys;
  const int tiles = (ls + tile_keys - 1) / tile_keys;
  const dim3 grid(tiles, heads, batch);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (plan.form == kStream) {
      const int warps = stream_warps(tile_keys);
      CUtensorMap maps[2];
      if (!make_map_3d(&maps[0], k, heads * head_dim, ls, batch, kStreamChunkKeys) ||
          !make_map_3d(&maps[1], v, heads * head_dim, ls, batch, kStreamChunkKeys)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const size_t smem = stream_layout(imin(beams, 16), tiles, warps).total;
      static size_t reserved = 0;
      static const cudaError_t carveout = cudaFuncSetAttribute(
          stream_cross_attention_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
      cudaError_t err = carveout;
      if (err == cudaSuccess) err = reserve_smem(stream_cross_attention_kernel, smem, &reserved);
      if (err != cudaSuccess) return static_cast<int>(err);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = tiles;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t config = {};
      config.gridDim = dim3(tiles, heads, batch * ((beams + 15) / 16));
      config.blockDim = dim3((warps + 1) * 32);   // the consumer warps and the loading warp
      config.dynamicSmemBytes = smem;
      config.stream = s;
      config.attrs = attr;
      config.numAttrs = 1;
      return static_cast<int>(cudaLaunchKernelEx(&config, stream_cross_attention_kernel,
                                                 maps[0], maps[1], qt, bt, static_cast<T*>(out),
                                                 beams, ls, scale));
    }
    if (plan.form == kCluster) {
      const int mt = (beams + 15) / 16;
      auto kernel = mt == 1 ? cluster_cross_attention_kernel<1> : cluster_cross_attention_kernel<2>;
      const size_t smem = cluster_layout(beams, tiles, tile_keys / kClusterWarpKeys).total;
      static size_t reserved[2] = {0, 0};
      const cudaError_t err = reserve_smem(kernel, smem, &reserved[mt - 1]);
      if (err != cudaSuccess) return static_cast<int>(err);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = tiles;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t config = {};
      config.gridDim = grid;
      config.blockDim = dim3(tile_keys);   // a warp per kClusterWarpKeys keys
      config.dynamicSmemBytes = smem;
      config.stream = s;
      config.attrs = attr;
      config.numAttrs = 1;
      return static_cast<int>(
          cudaLaunchKernelEx(&config, kernel, qt, kt, vt, bt, static_cast<T*>(out), beams, ls, scale));
    }
  }
  const size_t stats_smem =
      cross_layout(beams, head_dim, tile_keys, sizeof(T), true, false, 0).total;
  const size_t value_smem =
      cross_layout(beams, head_dim, tile_keys, sizeof(T), false, true, tiles).total;
  static size_t reserved[2] = {0, 0};
  cudaError_t err = reserve_smem(cross_stats_kernel<T>, stats_smem, &reserved[0]);
  if (err == cudaSuccess) err = reserve_smem(cross_value_kernel<T>, value_smem, &reserved[1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  cross_stats_kernel<T><<<grid, threads, stats_smem, s>>>(qt, kt, bt, ws, beams, head_dim, ls,
                                                          tile_keys, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_value_kernel<T><<<grid, threads, value_smem, s>>>(vt, static_cast<T*>(out), ws, beams,
                                                          head_dim, ls, tile_keys);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mmt

extern "C" {

const char* mmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of global workspace a select launch needs for a stage of `length`
// times (0 when its per-time tables fit in shared memory): kind as
// mmt_beam_select_attention_update's, or 3 / 4 for the read-only mode on a
// bf16 / int8 cache; -1 for a shape the kernel does not take.
long long mmt_beam_select_workspace_bytes(int kind, int batch, int beams, int heads,
                                          int head_dim, int length) {
  using namespace mmt;
  if (!select_shape_ok(beams, head_dim, length)) return -1;
  SelectLayout lay;
  switch (kind) {
    case 0: lay = select_plan<__nv_bfloat16, __nv_bfloat16, true>(beams, head_dim, length); break;
    case 1: lay = select_plan<int8_t, __nv_bfloat16, true>(beams, head_dim, length); break;
    case 2: lay = select_plan<int8_t, float, true>(beams, head_dim, length); break;
    case 3: lay = select_plan<__nv_bfloat16, __nv_bfloat16, false>(beams, head_dim, length); break;
    case 4: lay = select_plan<int8_t, __nv_bfloat16, false>(beams, head_dim, length); break;
    default: return -1;
  }
  if (lay.total > kMaxSmem) return -1;
  return lay.spill ? static_cast<long long>(lay.workspace) * batch * heads : 0;
}

// kind: 0 bf16 cache and bf16 fresh rows; 1 int8 cache, bf16 fresh rows;
// 2 int8 cache, fp32 fresh rows (quantized in the kernel). `pos` points to
// the step index (one int32 in device memory), `length` is the stage's
// time axis, `workspace` holds mmt_beam_select_workspace_bytes bytes (or
// is null when that is 0). Returns the cudaError_t of the launch (0 on
// success).
int mmt_beam_select_attention_update(int kind, const void* q, const void* k_new,
                                     const void* v_new, void* cache, void* scales,
                                     const void* ancestry, void* out, void* workspace,
                                     int batch, int beams, int heads, int head_dim, int flat,
                                     int flat_pad, int anc_row_stride, const int* pos,
                                     int length, float scale, void* stream) {
  using namespace mmt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch_select<__nv_bfloat16, __nv_bfloat16, true>(
          q, k_new, v_new, cache, nullptr, ancestry, out, workspace, batch, beams, heads,
          head_dim, flat, flat_pad, anc_row_stride, pos, length, scale, s);
    case 1:
      return launch_select<int8_t, __nv_bfloat16, true>(
          q, k_new, v_new, cache, scales, ancestry, out, workspace, batch, beams, heads,
          head_dim, flat, flat_pad, anc_row_stride, pos, length, scale, s);
    case 2:
      return launch_select<int8_t, float, true>(
          q, k_new, v_new, cache, scales, ancestry, out, workspace, batch, beams, heads,
          head_dim, flat, flat_pad, anc_row_stride, pos, length, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Read-only mode: q (batch * beams, D) bf16 rows, the cache already holds
// the time-pos rows; the other arguments as the update's. Returns the
// cudaError_t of the launch (0 on success).
int mmt_beam_select_attention(int quantized, const void* q, const void* cache,
                              const void* scales, const void* ancestry, void* out,
                              void* workspace, int batch, int beams, int heads, int head_dim,
                              int flat, int flat_pad, int anc_row_stride, const int* pos,
                              int length, float scale, void* stream) {
  using namespace mmt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return launch_select<int8_t, __nv_bfloat16, false>(
        q, nullptr, nullptr, const_cast<void*>(cache), const_cast<void*>(scales), ancestry, out,
        workspace, batch, beams, heads, head_dim, flat, flat_pad, anc_row_stride, pos, length,
        scale, s);
  }
  return launch_select<__nv_bfloat16, __nv_bfloat16, false>(
      q, nullptr, nullptr, const_cast<void*>(cache), nullptr, ancestry, out, workspace, batch,
      beams, heads, head_dim, flat, flat_pad, anc_row_stride, pos, length, scale, s);
}

// The cross plan for this shape: returns its keys per tile (at least Ls
// rounded to 16 for the one-pass form, else the tiles of the cluster or the
// split form, or the keys of a stream-form rank), or -1 for a shape the
// kernels do not take, and stores its form (0 one pass, 1 cluster, 2
// split, 3 stream) in *form and the bytes of global
// workspace a launch needs (0 but for the split form) in *workspace_bytes;
// is_bf16 as mmt_beam_cross_attention's.
int mmt_beam_cross_plan(int is_bf16, int batch, int beams, int heads, int head_dim, int ls,
                        int* form, long long* workspace_bytes) {
  const mmt::CrossPlan p = mmt::cross_plan(is_bf16 ? 2 : 4, batch, beams, heads, head_dim, ls);
  *form = p.form;
  *workspace_bytes = p.workspace;
  return p.tile_keys;
}

// is_bf16: 1 for bf16 q/k/v/out, 0 for float32. `workspace` holds
// `workspace_bytes` bytes, at least what mmt_beam_cross_plan gives. Returns
// the cudaError_t of the launches (0 on success).
int mmt_beam_cross_attention(int is_bf16, const void* q, const void* k, const void* v,
                             const void* bias, void* out, void* workspace,
                             long long workspace_bytes, int batch, int beams, int heads,
                             int head_dim, int ls, float scale, void* stream) {
  using namespace mmt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_cross<__nv_bfloat16>(q, k, v, bias, out, workspace, workspace_bytes, batch,
                                       beams, heads, head_dim, ls, scale, s);
  }
  return launch_cross<float>(q, k, v, bias, out, workspace, workspace_bytes, batch, beams,
                             heads, head_dim, ls, scale, s);
}

}  // extern "C"
