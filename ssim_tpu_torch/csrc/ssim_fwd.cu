// Fused SSIM forward for NVIDIA Hopper (sm_90a): the standard f32 tier,
// the precise (fp64) tier, the relaxed tier, the MS-SSIM components modes,
// one score per image for batches of small images, and per-row sums of a
// row band with halo operands for spatial sharding.
//
// Replaces the two TPU forward kernels of the JAX package:
// ssim_tpu/ops/ssim_pallas.py::_nopad_overlap_call (:710; full-width row
// tiles, widths up to 16384 lanes) in its modes a (standard, with or
// without the map), b (precise), c (components), d (pool_out, u8 and
// f32), e (colsum + pchunk, as ssim_parts_pallas_bpacked drives it,
// :2334), f (rowsum), g (vhalo / vmask halo operands) and h (relaxed,
// lane_mode "mxu3x", :118, :168, :288), and ::_chunked_overlap_call
// (:1364; the same over lane chunks for wider images) in its standard,
// map, precise, components, rowsum and relaxed (:1409) modes. That
// split exists only for TPU lane widths and VMEM; here one 2-D grid of
// output tiles covers every width, so K2's modes need no kernel of their
// own. Mode e also serves the contract of tools/probe_bpack.py::bpack_parts
// (K5, :56), a probe's 3-D batch-block kernel: per image sum(ssim - 1) +
// h*w.
//
// Modes (compile time, one copy of the halo load and the two blurs):
// - kScore / kMap: one f32 partial per tile, sum(ssim - 1) + n_valid, with
//   the SSIM formula of _ssim_from_blurs; kMap also writes the map.
// - kPrecise / kPreciseMap (precision="f64", the counterpart of the
//   reference's RMGR_SSIM_USE_DOUBLE build): the standard modes' blurs in
//   their order of operations, but in fp64 with the f64 taps (the f32
//   halo tiles widen exactly; the planes are double), then the formula of
//   _ssim_from_blurs in native fp64 (num / den, the algebra the TPU
//   kernel compensates in df32, _ssim_from_blurs_df32,
//   ssim_pallas.py:621-644). The TPU kernel blurs in f32 with f32 taps;
//   on a flat window (a 1x1 image, or any constant region) sigma =
//   E[x^2] - mu^2 then cancels to f32 rounding, up to 5e-5 per pixel
//   against the f64 oracle. fp64 blurs with the f32 taps still leave
//   8e-7 there (the f32 taps do not sum to 1, so a flat window keeps a
//   variance of mu^2 (1 - sum)); with the f64 taps ~1e-12. Then the tile's
//   sum(ssim - 1) accumulated in double, and ONE fp64 partial per tile,
//   sum(ssim - 1) + n_valid. The TPU kernel writes two f32 partials per
//   tile (the df32 hi and lo + e, :1188-1195); both are summed in f64 by
//   engine.finalize_mean, so the score is the same quantity. kPreciseMap
//   also writes the map as the f32 rounding of the fp64 value (the TPU
//   map is the df32 hi). c1 and c2 arrive as doubles, so the precise
//   formula sees them unrounded; the f32 modes take them rounded to
//   float on the host (c1f, c2f), as before the precise modes existed.
// - kComponents (MS-SSIM, _l_cs_from_blurs, ssim_pallas.py:480-490 and
//   :1196-1199): lum and cs from the four blurs, ssim = lum * cs (not the
//   standard num / den, so the last bits differ from kScore), and two
//   partials per tile, sum(cs - 1) + n_valid and sum(ssim - 1) + n_valid.
// - kPooled: kComponents plus the 2x2-mean images (B, H/2, W/2) f32 of a
//   and b, the MS-SSIM pyramid's next scale (ssim_pallas.py:1100-1174).
//   Each block pools its own pixels (TH and TW even; the stream's strips
//   and segments start at even columns and rows), from the raw inputs, not
//   the sanitised halo: a u8 value converts exactly, and a NaN in f32
//   input reaches its own pooled pixel as _downsample2's reduce_window
//   carries it. Vertical pairs are added first, then horizontal, then *
//   0.25; only pooled rows < H/2 and columns < W/2 are written, so an odd
//   last row or column is dropped and no row past the image is read. (The
//   Pallas f32 pool fed the unmasked rows of a ragged tile into a matrix
//   product, which made its pooled images NaN; reading only rows inside
//   the image repairs that.) Both modes stream rows (below) at every radius,
//   relaxed too.
// - kBatch / kBatchPrecise (the small-image batch route): one partial
//   pair per image, [sum(ssim - 1), n = H*W], f32 in kBatch (the JAX
//   contract's (B, 2)) and f64 in kBatchPrecise (where the TPU writes
//   (B, 3) [hi, lo, n]; both are summed in f64 by the finalize). Each
//   pixel's SSIM is kScore's (kPrecise's) bit for bit. At every radius
//   both run the packed row stream (ssim_fwd_batch_stream_kernel,
//   fwd_batch_kernel.cuh: ssim_fwd_batch.cu at radius 5,
//   ssim_fwd_batch_rt.cu at the others; one block a strip of a packed
//   row): the
//   TPU packs p images along one lane row and folds their borders into
//   block-diagonal tap matrices; here k images lie side by side in a
//   packed row cut into 128-column strips, and each image's piece of a
//   strip is staged with its own clamped columns; the relaxed kBatch too
//   (its heavy blurs as band products). The tile body, which a pinned
//   launch still reaches (_launch(tile_body=True)), runs over each
//   image's own grid of
//   tiles, with a tile width the wrapper picks from the image width
//   (8..64), and a block walks its tiles in series: `ipb` whole images, or
//   one of `groups` runs of one image's tiles. Each tile's sum is reduced
//   over the block in the tile modes' type and added to a double in thread
//   0; with groups > 1 the runs' doubles go to a scratch array and
//   batch_reduce_kernel adds each image's runs in order. In both designs
//   no atomics touch the sums (deterministic partials), a non-finite pixel
//   poisons its own image's sum and no other, and there are no padding
//   slots to drop.
//
// - kRowsum / kRowsumMap (score-only and map spatial sharding,
//   ssim_tpu_torch/parallel/spatial.py; K1f and K2's rowsum mode, :1080-1090
//   and :1641-1690): per-row sum(ssim - 1) instead of tile partials, and in
//   kRowsumMap also the map. A row spans ntx tiles of the 2-D grid, so each
//   tile reduces its rows' pieces (each warp's segment by shuffles, the
//   segments in order) into a (B, ntx, H) f32 scratch array, and
//   rowsum_reduce_kernel adds each row's ntx pieces in order, in double,
//   rounds to f32 and adds W in f32 (the JAX contract, rows + w). No
//   atomics: the row sums are deterministic. The TPU writes per-row sums
//   of one full-width tile; the map is never summed (F2).
// - Relaxed (kSplit > 0: accuracy="relaxed", K1h and K2's relaxed mode;
//   instantiated for kScore, kMap, kComponents, kPooled and kBatch, the
//   modes the JAX package runs relaxed): the two heavy horizontal blurs,
//   of (a+b)^2 and (a-b)^2, run as bf16x3 band products on the tensor
//   cores (band_mma.cuh; kSplit = its k-steps at this radius); the mu
//   blurs, the vertical pass, the formula, the NaN poison and the partials
//   are the standard modes'. The wrapper launches it at W >= 512 (and
//   always on the batch route), the JAX gate. The TPU's per-chunk
//   clamp-folded tap matrices (packed_chunk_matrices) are lane machinery:
//   the clamped columns are staged, so one band serves every tile. What
//   bounds it: per pixel the standard modes' f32 work less the heavy
//   passes' 6r + 4 operations, plus 3 (2r + 1) multiply-adds per split blur
//   at the bf16 tensor-core rate (counted in chip_smoke.py). kScore, kMap,
//   kComponents and kPooled stream rows at every radius
//   (ssim_fwd_stream_kernel, below; radius 5 in registers, the others in
//   ssim_fwd_stream_rt_relaxed.cu), and kBatch streams packed rows at every
//   radius (ssim_fwd_batch.cu, ssim_fwd_batch_rt.cu); tile_w 256 runs the
//   tile body, which makes
//   the split in registers as each k-step of data is loaded, once per
//   sweep, and so adds no shared memory (three blocks per SM, as the
//   standard modes), and whose relaxed mu pass loads as many shared-memory
//   values as the standard four-signal pass. Every relaxed line is behind
//   `if constexpr`, so the standard and precise instantiations compile to
//   the same SASS as without them.
// - Halo operands (K1g, ssim_pallas.py:884-958; the row modes take them,
//   the modes JAX offers them to; the other modes compile without them):
//   the inputs are a row band of a taller image, and virtual rows [-r, 0)
//   and [H, H + r) are read from four (B, r, W) operands (a_top, a_bot,
//   b_top, b_bot) instead of clamped to the band's edge rows. With is_top (is_bot) set, rows
//   above 0 (below H - 1) are clamped to the band's own edge row and the
//   operand is never read: the in-kernel replica substitution of the JAX
//   vmask mode, so the caller may pass raw ring outputs. Columns keep the
//   clamp. A row's source is chosen once per halo row, so the column loop
//   is the clamped mode's; operand rows never poison a tile (only its own
//   pixels do, as in the JAX kernel).
//
// What bounds it on this card: per output pixel it reads 2 input values
// (u8 or f32) and writes at most one f32 map value (kPooled: half an f32
// per input pixel), while the function needs 24r + 43 f32 operations
// (163 at radius 5: 4 signals x 2 passes x (3r + 2), the signals and the
// formula; kComponents 24r + 45, kPooled 24r + 47; kPrecise in fp64 the
// eight band blurs as 8 (2r + 1) multiply-adds, which the FP64 tensor
// cores could run, and 27 other operations; counted in chip_smoke.py).
// Device memory (3.35 TB/s) would allow ~1 Tpix/s for u8 without a map
// and the f32 peak ~410 Gpix/s, so the kernel is bound on chip: by the
// blurs' shared-memory
// traffic (~80 32-bit accesses per output pixel at radius 5) and
// instruction issue. The tile body measured 30-39 Gpix/s in mode kScore on
// an H100, the same with and without FMA contraction, and the same with the
// L2 flushed between launches; the streaming kernel below 62-81 Gpix/s. The
// pool adds 2 operations a pixel; the tile body reads the tile's inputs
// once more, from L1 or L2, where the halo load has just brought them, and
// the stream keeps them in shared memory as it stages each row. The
// components modes add a second division and a second tile sum a pixel.
// The precise modes run the ~130 blur operations per pixel
// in fp64 (half the f32 rate on an H100; the tile body, which still serves
// tile_w 256, keeps twice the planes' bytes in shared memory), plus the
// ~30 fp64 operations of the formula, one of them a division (a short
// software sequence).
// The batch modes do the same work per pixel; a 64-wide image fills half
// of the main-path stream's 128-column strip and walks only H + 2r rows,
// which the packed stream's full strips and H barriers an image avoid.
// What the tile body (ssim_fwd_kernel) does about it: each pixel of the
// halo tile is read from device memory once and converted to f32 on load;
// both blur passes run out of shared memory with symmetric tap pairs (r + 1
// multiplies per pass), warp-contiguous addresses (no bank conflicts) and
// the four signals a, b, (a+b)^2, (a-b)^2 computed in one sweep. That is
// still ~70 scalar shared-memory accesses per output pixel with a runtime
// radius (every tap a load), and the horizontal pass runs over all TH + 2r
// halo rows of a TH-row tile.
//
// The main-path modes stream rows instead (ssim_fwd_stream_kernel):
// kScore, kMap, kRowsum and kRowsumMap (with or without halo operands) and
// kComponents and kPooled (the same blurs, step (c)'s epilogue theirs) in
// f32, kPrecise and kPreciseMap in fp64 (the same body with the blurs'
// type Blur<kMode>) and relaxed kScore, kMap, kComponents and kPooled
// (kSplit > 0, below) at every radius, with tiles up to kStripW columns
// wide. At kStreamR = 5 (windows.RADIUS, every main-path shape and MS-SSIM
// scale) the window is in registers (these instantiations, below); any
// other radius, a custom window, runs ssim_fwd_stream_rt.cu's
// instantiation (ssim_fwd_stream_rt_relaxed.cu's, relaxed) with the radius
// read at run time and the window in a ring in shared memory (the standard
// and precise instantiations measured faster than the tile body at every
// radius 1-16; the relaxed ones lose at some radii, mostly kPooled on u8,
// where stream_applies keeps the tile body: STREAM_RELAXED_TILE_RADII,
// PERF.md). kBatch (either
// tier) and kBatchPrecise run its steps (b)-(d) over packed rows of images
// at every radius (ssim_fwd_batch_stream_kernel, fwd_batch_kernel.cuh);
// tile_w 256 keeps the tile body
// (ops/ssim_cuda.py::stream_applies states the rule; the components and
// pooled modes stream only from 2^20 pixels a launch, STREAM_COMP_MIN_PIX,
// relaxed from 2^22, STREAM_RELAXED_COMP_MIN_PIX: below them a block's
// serial chain of at least TH + 2r rows outlasts the tile body's parallel
// tiles). A block owns a
// strip of kStripW output columns and walks down a segment of S output rows
// (a multiple of TH, at most kMaxSegTiles tiles, chosen by the wrapper to
// fill the card), one input row per step, one thread per output column.
// Each step, with one __syncthreads:
//  (a) the warp sums of the step before combined into tile partials or row
//      pieces (one thread per tile);
//  (b) the horizontal blur of the staged input row, a shared-memory row of
//      {a, b, (a+b)^2, (a-b)^2} over the strip plus r columns each side
//      (the product signals formed once per pixel, the same values as the
//      twin's per-pair products). In f32 one float4 a column, 11 float4
//      loads per pixel. In fp64 two double2 planes, {a, b} and {(a+b)^2,
//      (a-b)^2}: a thread pair blurs two adjacent columns, the even thread
//      the first plane and the odd one the second, each from 2r + 2 loads,
//      and the two swap halves with one shuffle (12 16-byte loads for two
//      pixels' four signals, where one column per thread needs 22 for one);
//  (c) the four results pushed into a window of the last 2r + 1 rows (f32:
//      44 floats in registers; fp64: mu_a, mu_b and s_ss in 66 registers'
//      worth of doubles, s_dd in a per-thread shared-memory ring; the step
//      loop is unrolled by 2r + 1 so each row keeps its register or slot),
//      the vertical blur down the column, the formula, the map store and
//      the sums (double in the precise modes; in the components modes
//      _l_cs_from_blurs and two sums, cs and ssim, per column and tile,
//      two warp sums per tile and two partials; kPooled then pools the
//      last two rows staged (s - 1 and s; relaxed, three ahead, s + 1 and
//      s + 2) at each odd output row, 64 threads two columns each, from
//      the raw rows that (d) keeps in a shared-memory ring of 4);
//  (d) the next input row staged from registers loaded one step earlier
//      (sanitised, its own pixels' finiteness noted in a per-block tile
//      mask; kPooled also keeps its own columns raw) and the row after it
//      loaded, so device-memory latency overlaps a step's work.
// The taps are kernel parameters (constant operands once the loops
// unroll; the f64 taps and unrounded c1, c2 in the precise modes). Vertical
// recompute falls to (S + 2r) / S. What bounds it, f32: issue (per step
// and warp of 32 pixels ~200 f32 operations, built without FMA
// contraction, and ~150 loads, stores, address and control instructions)
// and latency (one barrier a row): time fell with each block per SM up to
// 8 (64 registers, a few spilled). Two columns per thread (12 float4 loads
// for two pixels from even/odd planes, a window of 88 floats) spilled at 7
// blocks per SM and measured 10-15% slower (PERF.md). fp64: per pixel ~164
// DADD/DMUL (no FMA contraction; 2.6 SM clocks at 64 a clock) and ~340
// bytes of shared-memory traffic (192 for the staged planes, 96 for the
// ring, the staging stores and the shuffle; 2.7 clocks at 128 bytes a
// clock), at 4 blocks per SM, which the window's registers bound (PERF.md
// lists the windows and passes measured). The relaxed modes: step (b)
// blurs only a and b across (the f32 symmetric pass of two signals from a
// staged {a, b} row, 11 8-byte loads a pixel), and the window holds mu_a
// and mu_b in registers; the heavy blurs of (a+b)^2 and (a-b)^2 are
// computed ahead, every other step for the next two rows, each row and
// plane by one warp as a bf16x3 band product whose 8 lines are the strip's
// 8 column tiles of 16 (12 mma.sync a row), into a shared-memory ring of
// 2 (2r + 1) blurred rows that the vertical pass reads at static offsets;
// the components and pooled modes add their epilogue to the same steps
// (6 blocks per SM, 80 registers: kStreamRelaxedCompBlocks).
// What bounds it: the mma. Measured on an H100, the mma a warp issues in a
// step hold its block at the step's barrier, in proportion to their number
// rather than to the chains' depth; so the 24 mma of two steps' rows go to
// all four warps at once, and a block stages rows three ahead
// (29.3 KB of shared memory, 7 blocks per SM, 72 registers: a window of
// all four signals in registers beside the mma's fragments spilled most
// of it to local memory at 8 blocks, PERF.md). A non-finite own
// pixel poisons its TH x TW tile: the tile's map rows are overwritten with
// NaN after its last row and its partial or row pieces are NaN, as in the
// tile body. Row pieces are formed as the tile body forms them (each
// warp's 32 columns by shuffles, the tile's warps in order), so a row's
// piece depends on its own columns alone, never on S or the band.
//
// Numerics follow the JAX kernel: clamp-to-edge borders (indices are
// clamped as the halo tile is loaded; nothing is padded in device
// memory), nan_to_num + clip of float inputs with NaN poisoning of the
// tile (its ssim and cs alike) when one of its own pixels is not finite,
// the four-signal formulas, and per-tile partials of x - 1 plus n_valid.
// One partial per block and value, no atomics: the result is
// deterministic. Build without --use_fast_math (it would flush subnormals
// and approximate the division) and with --fmad=false: each multiply and
// add, f32 or fp64, then rounds as in the plain PyTorch twins
// (ops/ssim_cuda.py), which do the same operations in the same order, and
// fp64 division is IEEE, so per-pixel values and pooled images match the
// twins bit for bit and only the order of the tile sums differs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "band_mma.cuh"
#include "fwd_common.cuh"

namespace {

template <typename T, int kMode, int kSplit>
__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                void* __restrict__ partials, float* __restrict__ map,
                float* __restrict__ pool_a, float* __restrict__ pool_b,
                void* __restrict__ scratch, Halo<T> halo, int B, int H, int W,
                int r, int TH, int TW, int ntx, int tiles_per_image, int ipb,
                int groups, Taps<Blur<kMode>> taps, float c1f, float c2f, double c1,
                double c2, float clip_bound) {
  constexpr bool kFloat = sizeof(T) == 4;
  constexpr bool kComp = kMode == kComponents || kMode == kPooled;
  constexpr bool kPrec = kIsPrecise<kMode>;
  constexpr bool kWithMap =
      kMode == kMap || kMode == kPreciseMap || kMode == kRowsumMap;
  constexpr bool kBatchMode = kMode == kBatch || kMode == kBatchPrecise;
  constexpr bool kRows = kMode == kRowsum || kMode == kRowsumMap;
  // The relaxed modes: kSplit = band_mma::ksteps(r), 0 in the others.
  constexpr bool kRelaxed = kSplit > 0;
  // The blurs' type (the taps and planes too) and the tile sums': double
  // in the precise modes, else float; the halo tiles hold the f32 inputs,
  // which widen exactly.
  using P = Blur<kMode>;
  using Acc = P;
  extern __shared__ float smem[];
  __shared__ P s_taps[kMaxTaps];
  __shared__ Acc s_warp[kComp ? 2 : 1][kThreads / 32];  // [0]: ssim, [1]: cs

  const int HR = TH + 2 * r;  // halo rows
  const int HW = TW + 2 * r;  // halo columns
  float* sa = smem;           // HR x HW
  float* sb = sa + HR * HW;   // HR x HW
  // 4 planes of HR x TW: mu_a, mu_b, ss, dd (8-byte aligned: 2 HR HW floats).
  P* hp = reinterpret_cast<P*>(sb + HR * HW);
  const int plane = HR * TW;

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) s_taps[k] = taps.t[k];
  }

  // The block's tiles [w0, w1) in the order of the tile modes' grid: one
  // tile in the tile modes; in the batch modes ipb whole images, or run g
  // of `groups` runs of one image's tiles (as even as whole tiles allow),
  // whose last tile is t1 - 1 of its image.
  int w0 = blockIdx.x, w1 = w0 + 1, g = 0, t1 = tiles_per_image;
  if constexpr (kBatchMode) {
    if (groups == 1) {
      const int i0 = blockIdx.x * ipb;
      w0 = i0 * tiles_per_image;
      w1 = min(B, i0 + ipb) * tiles_per_image;
    } else {
      const int i0 = blockIdx.x / groups;
      g = blockIdx.x - i0 * groups;
      t1 = (int)((long long)(g + 1) * tiles_per_image / groups);
      w0 = i0 * tiles_per_image + (int)((long long)g * tiles_per_image / groups);
      w1 = i0 * tiles_per_image + t1;
    }
  }
  // Batch modes: the image's sum over this block's tiles, in double, so a
  // tall image keeps the tile sums' ulp.
  double acc = 0.0;

  // A block that walks several tiles reuses its shared memory at once:
  // every read of the halo and the planes comes before a tile's last
  // barrier, and thread 0 reads s_warp before the next tile's first.
  for (int tile = w0; tile < w1; ++tile) {
    const int img = tile / tiles_per_image;
    const int rem = tile - img * tiles_per_image;
    const int y0 = (rem / ntx) * TH;
    const int x0 = (rem % ntx) * TW;
    const int vh = min(TH, H - y0);  // valid output rows of this tile
    const int vw = min(TW, W - x0);  // valid output columns
    const size_t base = (size_t)img * (size_t)H * (size_t)W;

    // TW is a power of two in [8, 256], so TW threads cover a row.
    const int tx = tid % TW;
    const int ty = tid / TW;
    const int ystep = kThreads / TW;

    // Load the halo tile, converting to f32: each row from the band
    // (clamped) or, in the row modes, from a halo operand; each column
    // clamped. The other modes compile to the clamped load alone.
    int bad = 0;
    for (int ly = ty; ly < vh + 2 * r; ly += ystep) {
      const int uy = y0 - r + ly;
      const T* ra;
      const T* rb;
      if (kRows && uy < 0 && halo.at != nullptr && !halo.is_top) {
        const size_t row = ((size_t)img * r + (size_t)(uy + r)) * (size_t)W;
        ra = halo.at + row;
        rb = halo.bt + row;
      } else if (kRows && uy >= H && halo.ab != nullptr && !halo.is_bot) {
        const size_t row = ((size_t)img * r + (size_t)(uy - H)) * (size_t)W;
        ra = halo.ab + row;
        rb = halo.bb + row;
      } else {
        const int gy = min(max(uy, 0), H - 1);
        const size_t row = base + (size_t)gy * (size_t)W;
        ra = a + row;
        rb = b + row;
      }
      for (int lx = tx; lx < vw + 2 * r; lx += TW) {
        const int ux = x0 - r + lx;
        const int gx = min(max(ux, 0), W - 1);
        float va = to_f32(ra[gx]);
        float vb = to_f32(rb[gx]);
        if (kFloat) {
          // Poison source: the tile's own valid pixels, unsanitised.
          const bool own = ly >= r && ly < r + vh && lx >= r && lx < r + vw;
          if (own && !(finite_f32(va) && finite_f32(vb))) bad = 1;
          va = sanitize(va, clip_bound);
          vb = sanitize(vb, clip_bound);
        }
        sa[ly * HW + lx] = va;
        sb[ly * HW + lx] = vb;
      }
    }
    bad = __syncthreads_or(bad);

    if constexpr (kRelaxed) {
      // The mu blurs as in the standard modes; the heavy (a+b)^2 and
      // (a-b)^2 blurs as bf16x3 band products on the tensor cores
      // (band_mma::sweep, both planes at once).
      for (int ly = ty; ly < vh + 2 * r; ly += ystep) {
        for (int lx = tx; lx < vw; lx += TW) {
          const float* ra = sa + ly * HW + lx + r;
          const float* rb = sb + ly * HW + lx + r;
          float ma = 0.0f, mb = 0.0f;
          for (int d = r; d >= 1; --d) {
            const float t = s_taps[r - d];
            ma += t * (ra[-d] + ra[d]);
            mb += t * (rb[-d] + rb[d]);
          }
          const float tc = s_taps[r];
          const int o = ly * TW + lx;
          hp[o] = ma + tc * ra[0];
          hp[plane + o] = mb + tc * rb[0];
        }
      }
      // Columns along the pass, halo rows across it in strips of 8.
      const int nrows = vh + 2 * r, ncols = vw + 2 * r;
      const int grp = (tid & 31) >> 2, tig = tid & 3;  // lane = 4 grp + tig
      band_mma::for_jobs(nrows, (vw + 15) >> 4, [&](int strip, int t0, int t1) {
        const int row = min(8 * strip + grp, nrows - 1) * HW;
        band_mma::sweep<2, kSplit>(
            s_taps, r, t0, t1,
            [&](int c, float(&v)[2]) {
              float x = 0.0f, y = 0.0f;
              if (c < ncols) {
                x = sa[row + c];
                y = sb[row + c];
              }
              const float s = x + y, d = x - y;
              v[0] = s * s;
              v[1] = d * d;
            },
            [&](int ti, const float(&acc)[2][4]) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int lx = 16 * ti + grp + 8 * (e >> 1);
                const int ly = 8 * strip + 2 * tig + (e & 1);
                if (ly < nrows && lx < vw) {
                  hp[2 * plane + ly * TW + lx] = acc[0][e];
                  hp[3 * plane + ly * TW + lx] = acc[1][e];
                }
              }
            });
      });
    } else {
      // Horizontal pass over every halo row: four signals, symmetric pairs,
      // smallest taps first.
      for (int ly = ty; ly < vh + 2 * r; ly += ystep) {
        for (int lx = tx; lx < vw; lx += TW) {
          const float* ra = sa + ly * HW + lx + r;
          const float* rb = sb + ly * HW + lx + r;
          P ma = 0, mb = 0, ss = 0, dd = 0;
          for (int d = r; d >= 1; --d) {
            const P t = s_taps[r - d];
            const P al = ra[-d], ah = ra[d], bl = rb[-d], bh = rb[d];
            const P sl = al + bl, sh = ah + bh, dl = al - bl, dh = ah - bh;
            ma += t * (al + ah);
            mb += t * (bl + bh);
            ss += t * (sl * sl + sh * sh);
            dd += t * (dl * dl + dh * dh);
          }
          const P tc = s_taps[r];
          const P ac = ra[0], bc = rb[0];
          const P sc = ac + bc, dc = ac - bc;
          const int o = ly * TW + lx;
          hp[o] = ma + tc * ac;
          hp[plane + o] = mb + tc * bc;
          hp[2 * plane + o] = ss + tc * (sc * sc);
          hp[3 * plane + o] = dd + tc * (dc * dc);
        }
      }
    }
    __syncthreads();

    // Vertical pass, the SSIM formula, the map and the tile sums.
    Acc local = 0, local_cs = 0;
    for (int ly = ty; ly < vh; ly += ystep) {
      [[maybe_unused]] float row_acc = 0.0f;  // kRows: this thread's part of row ly
      for (int lx = tx; lx < vw; lx += TW) {
        const P* c = hp + (ly + r) * TW + lx;
        P m0 = 0, m1 = 0, m2 = 0, m3 = 0;
        for (int d = r; d >= 1; --d) {
          const P t = s_taps[r - d];
          const int o = d * TW;
          m0 += t * (c[-o] + c[o]);
          m1 += t * (c[plane - o] + c[plane + o]);
          m2 += t * (c[2 * plane - o] + c[2 * plane + o]);
          m3 += t * (c[3 * plane - o] + c[3 * plane + o]);
        }
        const P tc = s_taps[r];
        const P mu_a = m0 + tc * c[0];
        const P mu_b = m1 + tc * c[plane];
        const P s_ss = m2 + tc * c[2 * plane];
        const P s_dd = m3 + tc * c[3 * plane];
        Acc v, cs = 0;
        if constexpr (kPrec) {
          // _ssim_from_blurs (ssim_pallas.py:465-477) in fp64 on the
          // fp64 blurs.
          const double da = mu_a, db = mu_b, dss = s_ss, ddd = s_dd;
          const double mu_a2 = da * da;
          const double mu_b2 = db * db;
          const double mu_ab = da * db;
          const double sigma_ab_x4 = (dss - ddd) - 4.0 * mu_ab;
          const double sigma_sum_x2 = (dss + ddd) - 2.0 * (mu_a2 + mu_b2);
          const double num = (2.0 * mu_ab + c1) * (0.5 * sigma_ab_x4 + c2);
          const double den = (mu_a2 + mu_b2 + c1) * (0.5 * sigma_sum_x2 + c2);
          v = num / den;
        } else {
          // _ssim_from_blurs (ssim_pallas.py:465-477) or, for the
          // components, _l_cs_from_blurs (:480-490).
          const float mu_a2 = mu_a * mu_a;
          const float mu_b2 = mu_b * mu_b;
          const float mu_ab = mu_a * mu_b;
          const float sigma_ab_x4 = (s_ss - s_dd) - 4.0f * mu_ab;
          const float sigma_sum_x2 = (s_ss + s_dd) - 2.0f * (mu_a2 + mu_b2);
          if (kComp) {
            const float lum = (2.0f * mu_ab + c1f) / (mu_a2 + mu_b2 + c1f);
            cs = (0.5f * sigma_ab_x4 + c2f) / (0.5f * sigma_sum_x2 + c2f);
            v = lum * cs;
          } else {
            const float num = (2.0f * mu_ab + c1f) * (0.5f * sigma_ab_x4 + c2f);
            const float den =
                (mu_a2 + mu_b2 + c1f) * (0.5f * sigma_sum_x2 + c2f);
            v = num / den;
          }
        }
        if (kFloat && bad) {
          v = (Acc)__int_as_float(0x7fc00000);  // NaN
          cs = v;
        }
        if (kWithMap) {
          map[base + (size_t)(y0 + ly) * (size_t)W + (size_t)(x0 + lx)] =
              (float)v;
        }
        if constexpr (kRows) {
          row_acc += (float)v - 1.0f;
        } else {
          local += v - (Acc)1;
          if (kComp) local_cs += cs - (Acc)1;
        }
      }
      if constexpr (kRows) {
        // TW >= 32: a warp holds one 32-column segment of row ly (every
        // lane the same ly), reduced by shuffles into lane 0 and kept in
        // the halo tile's shared memory, which no thread reads any more.
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          row_acc += __shfl_down_sync(0xffffffffu, row_acc, off);
        }
        if ((tid & 31) == 0) sa[ly * (TW / 32) + tx / 32] = row_acc;
      }
    }

    if constexpr (kRows) {
      // The tile's piece of each of its rows: its segments in order.
      __syncthreads();
      const int nseg = TW / 32;
      float* pieces = static_cast<float*>(scratch);
      const size_t prow = ((size_t)img * ntx + (size_t)(rem % ntx)) * (size_t)H;
      for (int ly = tid; ly < vh; ly += kThreads) {
        float s = 0.0f;
        for (int k = 0; k < nseg; ++k) s += sa[ly * nseg + k];
        pieces[prow + (size_t)(y0 + ly)] = s;
      }
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        local += __shfl_down_sync(0xffffffffu, local, off);
        if (kComp) local_cs += __shfl_down_sync(0xffffffffu, local_cs, off);
      }
      if ((tid & 31) == 0) {
        s_warp[0][tid >> 5] = local;
        if constexpr (kComp) s_warp[1][tid >> 5] = local_cs;
      }
      __syncthreads();
      if (tid == 0) {
        const Acc n_valid = (Acc)(vh * vw);
        Acc s = 0, s_cs = 0;
#pragma unroll
        for (int w = 0; w < kThreads / 32; ++w) {
          s += s_warp[0][w];
          if constexpr (kComp) s_cs += s_warp[1][w];
        }
        if constexpr (kBatchMode) {
          acc += (double)s;
          if (rem == t1 - 1) {  // the image's last tile in this block
            if (groups == 1) {
              Acc* p = static_cast<Acc*>(partials);
              p[2 * (size_t)img] = (Acc)acc;
              p[2 * (size_t)img + 1] = (Acc)((double)H * (double)W);
            } else {
              static_cast<double*>(scratch)[(size_t)img * groups + g] = acc;
            }
            acc = 0.0;
          }
        } else if constexpr (kComp) {
          float* p = static_cast<float*>(partials);
          p[2 * (size_t)tile] = s_cs + n_valid;
          p[2 * (size_t)tile + 1] = s + n_valid;
        } else {
          static_cast<Acc*>(partials)[tile] = s + n_valid;
        }
      }

      if (kMode == kPooled) {
        // The tile's own 2x2 blocks: pooled rows y0/2 .. and columns x0/2 ..,
        // TW/2 threads (a power of two in [16, 128]) across a pooled row.
        const int H2 = H / 2, W2 = W / 2;
        const int py0 = y0 / 2, px0 = x0 / 2;
        const int ph = min(TH / 2, H2 - py0);
        const int pw = min(TW / 2, W2 - px0);
        const int PW = TW / 2;
        const int px = tid % PW;
        const size_t pbase = (size_t)img * (size_t)H2 * (size_t)W2;
        for (int py = tid / PW; py < ph && px < pw; py += kThreads / PW) {
          const size_t r0 =
              base + (size_t)(2 * (py0 + py)) * (size_t)W + (size_t)(2 * (px0 + px));
          const size_t r1 = r0 + (size_t)W;
          const size_t o =
              pbase + (size_t)(py0 + py) * (size_t)W2 + (size_t)(px0 + px);
          const float ya0 = to_f32(a[r0]) + to_f32(a[r1]);
          const float ya1 = to_f32(a[r0 + 1]) + to_f32(a[r1 + 1]);
          pool_a[o] = (ya0 + ya1) * 0.25f;
          const float yb0 = to_f32(b[r0]) + to_f32(b[r1]);
          const float yb1 = to_f32(b[r0 + 1]) + to_f32(b[r1 + 1]);
          pool_b[o] = (yb0 + yb1) * 0.25f;
        }
      }
    }
  }  // tiles
}

// The batch modes' second pass where one image's tiles were split over
// `groups` blocks: each image's runs added in order, in double, then its
// partial pair [sum(ssim - 1), n]. One thread per image.
template <typename Out>
__global__ void batch_reduce_kernel(const double* __restrict__ scratch,
                                    Out* __restrict__ partials, int B,
                                    int groups, double n) {
  const int img = blockIdx.x * blockDim.x + threadIdx.x;
  if (img >= B) return;
  double s = 0.0;
  for (int g = 0; g < groups; ++g) s += scratch[(size_t)img * groups + g];
  partials[2 * (size_t)img] = (Out)s;
  partials[2 * (size_t)img + 1] = (Out)n;
}

}  // namespace

// ---------------------------------------------------------------------------
// The main-path modes: row-streaming column strips.
// Their constants and steps (b)-(d), which the batch modes' packed
// stream shares (ssim_fwd_batch.cu), are in fwd_stream.cuh.

#include "fwd_stream.cuh"
#include "fwd_stream_kernel.cuh"

namespace {

template <typename T, int kMode, int kSplit>
cudaError_t launch_stream(const void* a, const void* b, void* partials,
                          void* map, void* pool_a, void* pool_b, void* scratch,
                          const Halo<T>& halo, int B, int H, int W, int TH, int TW,
                          int S, const double* taps_host, double c1, double c2,
                          float clip_bound, cudaStream_t stream) {
  using P = Blur<kMode>;
  constexpr bool kRows = kMode == kRowsum || kMode == kRowsumMap;
  if (kMode == kPooled && ((TH | TW) & 1)) return cudaErrorInvalidValue;
  // The f32 modes round the taps and c1, c2 to float; the precise modes
  // keep the f64 taps and the unrounded constants.
  StreamTaps<P> tp;
  for (int k = 0; k < 2 * kStreamR + 1; ++k) tp.t[k] = (P)taps_host[k];
  const int nstrip = (W + kStripW - 1) / kStripW;
  const int nseg = (H + S - 1) / S;
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const long long blocks = (long long)B * nseg * nstrip;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ssim_fwd_stream_kernel<T, kMode, kSplit><<<(unsigned)blocks, kStreamThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<P*>(partials),
      static_cast<float*>(map), static_cast<float*>(scratch), halo, H, W, TH, TW, S,
      nstrip, nseg, ntx, nty, tp, (P)c1, (P)c2, clip_bound, static_cast<float*>(pool_a),
      static_cast<float*>(pool_b));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !kRows) return err;
  const long long n = (long long)B * H;
  rowsum_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(static_cast<const float*>(scratch),
                                   static_cast<float*>(partials), B, ntx, H,
                                   (float)W);
  return cudaGetLastError();
}

template <int kMode, int kSplit>
cudaError_t launch_stream_typed(int is_float, const void* a, const void* b,
                                void* partials, void* map, void* pool_a, void* pool_b,
                                void* scratch, const void* const* halo, int is_top,
                                int is_bot, int B, int H, int W, int TH, int TW, int S,
                                const double* taps_host, double c1, double c2,
                                float clip_bound, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_float
             ? launch_stream<float, kMode, kSplit>(
                   a, b, partials, map, pool_a, pool_b, scratch,
                   make_halo<float>(halo, is_top, is_bot), B, H, W, TH, TW, S,
                   taps_host, c1, c2, clip_bound, s)
             : launch_stream<uint8_t, kMode, kSplit>(
                   a, b, partials, map, pool_a, pool_b, scratch,
                   make_halo<uint8_t>(halo, is_top, is_bot), B, H, W, TH, TW, S,
                   taps_host, c1, c2, clip_bound, s);
}

template <typename T, int kMode, int kSplit>
cudaError_t stream_occupancy(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ssim_fwd_stream_kernel<T, kMode, kSplit>, kStreamThreads, 0);
}

template <typename T, int kMode, int kSplit>
cudaError_t launch(const void* a, const void* b, void* partials, void* map,
                   void* pool_a, void* pool_b, void* scratch,
                   const Halo<T>& halo, int B, int H, int W, int r, int TH,
                   int TW, int ipb, int groups, const double* taps_host,
                   double c1, double c2, float clip_bound,
                   cudaStream_t stream) {
  using P = Blur<kMode>;
  constexpr bool kBatchMode = kMode == kBatch || kMode == kBatchPrecise;
  constexpr bool kRows = kMode == kRowsum || kMode == kRowsumMap;
  if (kMode == kPooled && ((TH | TW) & 1)) return cudaErrorInvalidValue;
  Taps<P> taps;
  for (int k = 0; k < kMaxTaps; ++k) {
    taps.t[k] = k < 2 * r + 1 ? (P)taps_host[k] : P(0);
  }
  const int ntx = (W + TW - 1) / TW;
  const int nty = (H + TH - 1) / TH;
  const int tiles_per_image = ntx * nty;
  long long blocks = (long long)B * tiles_per_image;
  if (kBatchMode) {
    blocks = groups > 1 ? (long long)B * groups : ((long long)B + ipb - 1) / ipb;
  }
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // The halo tiles in f32, the planes in the blurs' type (ssim_cuda.smem_bytes).
  const size_t smem = sizeof(float) * (size_t)2 * (TH + 2 * r) * (TW + 2 * r) +
                      sizeof(P) * (size_t)4 * (TH + 2 * r) * TW;
  cudaError_t err = cudaFuncSetAttribute(
      ssim_fwd_kernel<T, kMode, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssim_fwd_kernel<T, kMode, kSplit><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), partials,
      static_cast<float*>(map), static_cast<float*>(pool_a),
      static_cast<float*>(pool_b), scratch, halo, B, H, W, r, TH, TW, ntx,
      tiles_per_image, ipb, groups, taps, (float)c1, (float)c2, c1, c2,
      clip_bound);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (kRows) {
    const long long n = (long long)B * H;
    rowsum_reduce_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                           0, stream>>>(static_cast<const float*>(scratch),
                                        static_cast<float*>(partials), B, ntx,
                                        H, (float)W);
    return cudaGetLastError();
  }
  if (!kBatchMode || groups == 1) return err;
  using Acc = typename std::conditional<kMode == kBatchPrecise, double, float>::type;
  batch_reduce_kernel<Acc><<<(B + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(static_cast<const double*>(scratch),
                                       static_cast<Acc*>(partials), B, groups,
                                       (double)H * (double)W);
  return cudaGetLastError();
}

template <int kMode, int kSplit>
cudaError_t launch_typed(int is_float, const void* a, const void* b,
                         void* partials, void* map, void* pool_a,
                         void* pool_b, void* scratch, const void* const* halo,
                         int is_top, int is_bot, int B, int H, int W, int r,
                         int TH, int TW, int ipb, int groups,
                         const double* taps_host, double c1, double c2,
                         float clip_bound, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_float
             ? launch<float, kMode, kSplit>(a, b, partials, map, pool_a, pool_b,
                                    scratch,
                                    make_halo<float>(halo, is_top, is_bot), B,
                                    H, W, r, TH, TW, ipb, groups, taps_host,
                                    c1, c2, clip_bound, s)
             : launch<uint8_t, kMode, kSplit>(a, b, partials, map, pool_a, pool_b,
                                      scratch,
                                      make_halo<uint8_t>(halo, is_top, is_bot),
                                      B, H, W, r, TH, TW, ipb, groups,
                                      taps_host, c1, c2, clip_bound, s);
}

}  // namespace

// ssim_fwd_stream_rt.cu: the streaming launches at other radii.
extern "C" int ssim_fwd_stream_rt_launch(int mode, int is_float, const void* a,
                                         const void* b, void* partials, void* map,
                                         void* pool_a, void* pool_b, void* scratch,
                                         const void* const* halo, int is_top, int is_bot,
                                         int B, int H, int W, int r, int TH, int TW,
                                         int seg, const double* taps_host, double c1,
                                         double c2, float clip_bound, void* stream);
extern "C" int ssim_fwd_stream_rt_occupancy(int mode, int is_float, int r,
                                            int* blocks_per_sm);
// ssim_fwd_stream_rt_relaxed.cu: the relaxed streaming launches at other radii.
extern "C" int ssim_fwd_stream_rt_relaxed_launch(int mode, int is_float, const void* a,
                                                 const void* b, void* partials, void* map,
                                                 void* pool_a, void* pool_b, int B, int H,
                                                 int W, int r, int TH, int TW, int seg,
                                                 const double* taps_host, double c1,
                                                 double c2, float clip_bound, void* stream);
extern "C" int ssim_fwd_stream_rt_relaxed_occupancy(int mode, int is_float, int r,
                                                    int* blocks_per_sm);

// The C entry for ctypes. mode: 0 = kScore, 1 = kMap, 2 = kComponents,
// 3 = kPooled, 4 = kPrecise, 5 = kPreciseMap, 6 = kBatch, 7 =
// kBatchPrecise, 8 = kRowsum, 9 = kRowsumMap; any other value is refused
// (the precise tier has no components or pooled mode). relaxed: 1 for the
// relaxed instantiation of modes 0, 1, 2, 3 and 6 (refused with the
// others), else 0. is_float: 0 = uint8
// inputs, 1 = float32 inputs. partials: (B, ceil(H/TH) * ceil(W/TW)) f32
// in the tile modes, with a trailing 2 of [cs, ssim] in the components
// modes, and f64 in the precise modes; (B, 2) [sum(ssim - 1), H*W] in the
// batch modes, f32 in kBatch and f64 in kBatchPrecise; (B, H) f32 row
// sums of ssim in the row modes. map: (B, H, W) f32 in kMap, kPreciseMap
// and kRowsumMap, else NULL. pool_a, pool_b: (B, H/2, W/2) f32 each in
// kPooled (TH and TW even), else NULL. TW: a power of two in [8, 256]
// (>= 32 in the row modes). ipb, groups (batch modes only; 1 and 1
// elsewhere): each block takes ipb whole images, or one of `groups` runs
// of one image's tiles, not both. scratch: (B, groups) f64 in the batch
// modes when groups > 1, (B, ceil(W/TW), H) f32 in the row modes, else
// NULL. a_top, a_bot, b_top, b_bot: the halo operands, (B, r, W) of the
// inputs' type, all four or none, in the row modes only; is_top, is_bot:
// their flags (0 or 1). taps_host: 2r+1 doubles in host memory: the f32
// taps widened, or in the precise modes the f64 taps (ssim_cuda._prepare;
// the other modes round them to float). c1, c2:
// the stabilising constants (rounded to float by the f32 modes). seg: 0
// for the tile body, or the streaming kernel's segment rows (modes 0-5, 8
// and 9 at any radius, r = 5 in the register-window instantiations, else
// ssim_fwd_stream_rt.cu's runtime radius; relaxed modes 0-3 likewise, their
// other radii in ssim_fwd_stream_rt_relaxed.cu; TW in [32, 128], seg a
// multiple of TH of at most 16 tiles; anything else is refused). Returns
// the launch's cudaError_t.
extern "C" int ssim_fwd_launch(int mode, int relaxed, int is_float,
                               const void* a, const void* b, void* partials,
                               void* map,
                               void* pool_a, void* pool_b, void* scratch,
                               const void* a_top, const void* a_bot,
                               const void* b_top, const void* b_bot,
                               int is_top, int is_bot, int B, int H, int W,
                               int r, int TH, int TW, int ipb, int groups,
                               int seg, const double* taps_host, double c1,
                               double c2, float clip_bound, void* stream) {
  const bool batch = mode == kBatch || mode == kBatchPrecise;
  const bool rows = mode == kRowsum || mode == kRowsumMap;
  const void* halo[4] = {a_top, a_bot, b_top, b_bot};
  const int n_halo = (a_top != nullptr) + (a_bot != nullptr) +
                     (b_top != nullptr) + (b_bot != nullptr);
  if ((map != nullptr) !=
          (mode == kMap || mode == kPreciseMap || mode == kRowsumMap) ||
      (pool_a != nullptr) != (mode == kPooled) ||
      (pool_b != nullptr) != (mode == kPooled) ||
      (scratch != nullptr) != ((batch && groups > 1) || rows) || ipb < 1 ||
      groups < 1 || (ipb > 1 && groups > 1) ||
      (!batch && (ipb != 1 || groups != 1)) || TW < 1 || TW > 256 ||
      (TW & (TW - 1)) != 0 || TH < 1 || (rows && TW < 32) ||
      (n_halo != 0 && (n_halo != 4 || !rows))) {
    return cudaErrorInvalidValue;
  }
  if (seg != 0) {
    if ((relaxed && mode != kScore && mode != kMap && mode != kComponents &&
         mode != kPooled) ||
        batch || r < 1 || r > kMaxStreamR || TW < 32 ||
        TW > kStripW || seg < TH || seg % TH != 0 || seg / TH > kMaxSegTiles ||
        H < 1 || W < 1) {
      return cudaErrorInvalidValue;
    }
    if (r != kStreamR && relaxed) {
      return ssim_fwd_stream_rt_relaxed_launch(mode, is_float, a, b, partials, map, pool_a,
                                               pool_b, B, H, W, r, TH, TW, seg, taps_host,
                                               c1, c2, clip_bound, stream);
    }
    if (r != kStreamR) {
      return ssim_fwd_stream_rt_launch(mode, is_float, a, b, partials, map, pool_a, pool_b,
                                       scratch, halo, is_top, is_bot, B, H, W, r, TH, TW,
                                       seg, taps_host, c1, c2, clip_bound, stream);
    }
#define SSIM_FWD_STREAM(M, S)                                                  \
  case M:                                                                      \
    return launch_stream_typed<M, S>(is_float, a, b, partials, map, pool_a,    \
                                     pool_b, scratch, halo, is_top, is_bot, B, \
                                     H, W, TH, TW, seg, taps_host, c1, c2,     \
                                     clip_bound, stream);
    if (relaxed) {
      switch (mode) {
        SSIM_FWD_STREAM(kScore, kStreamSplit)
        SSIM_FWD_STREAM(kMap, kStreamSplit)
        SSIM_FWD_STREAM(kComponents, kStreamSplit)
        SSIM_FWD_STREAM(kPooled, kStreamSplit)
        default:
          return cudaErrorInvalidValue;
      }
    }
    switch (mode) {
      SSIM_FWD_STREAM(kScore, 0)
      SSIM_FWD_STREAM(kMap, 0)
      SSIM_FWD_STREAM(kRowsum, 0)
      SSIM_FWD_STREAM(kRowsumMap, 0)
      SSIM_FWD_STREAM(kPrecise, 0)
      SSIM_FWD_STREAM(kPreciseMap, 0)
      SSIM_FWD_STREAM(kComponents, 0)
      SSIM_FWD_STREAM(kPooled, 0)
      default:
        return cudaErrorInvalidValue;
    }
#undef SSIM_FWD_STREAM
  }
#define SSIM_FWD_CASE(M, S)                                                 \
  case M:                                                                  \
    return launch_typed<M, S>(is_float, a, b, partials, map, pool_a,      \
                              pool_b, scratch, halo, is_top, is_bot, B, H, \
                              W, r, TH, TW, ipb, groups, taps_host, c1,    \
                              c2, clip_bound, stream);
#define SSIM_FWD_RELAXED(S)               \
  switch (mode) {                         \
    SSIM_FWD_CASE(kScore, S)              \
    SSIM_FWD_CASE(kMap, S)                \
    SSIM_FWD_CASE(kComponents, S)         \
    SSIM_FWD_CASE(kPooled, S)             \
    SSIM_FWD_CASE(kBatch, S)              \
    default:                              \
      return cudaErrorInvalidValue;       \
  }
  if (relaxed && (r < 1 || r > kMaxTaps / 2)) return cudaErrorInvalidValue;
  if (relaxed && band_mma::ksteps(r) == 2) SSIM_FWD_RELAXED(2)
  if (relaxed) SSIM_FWD_RELAXED(3)
#undef SSIM_FWD_RELAXED
  switch (mode) {
    SSIM_FWD_CASE(kScore, 0)
    SSIM_FWD_CASE(kMap, 0)
    SSIM_FWD_CASE(kComponents, 0)
    SSIM_FWD_CASE(kPooled, 0)
    SSIM_FWD_CASE(kPrecise, 0)
    SSIM_FWD_CASE(kPreciseMap, 0)
    SSIM_FWD_CASE(kBatch, 0)
    SSIM_FWD_CASE(kBatchPrecise, 0)
    SSIM_FWD_CASE(kRowsum, 0)
    SSIM_FWD_CASE(kRowsumMap, 0)
    default:
      return cudaErrorInvalidValue;
  }
#undef SSIM_FWD_CASE
}

// Blocks of the streaming kernel that one SM of the current device holds at
// once in `mode` (0-5, 8 or 9; relaxed = 1: 0-3) at radius r for uint8
// (is_float = 0) or float32 inputs: the CUDA runtime's occupancy for the
// instantiation that ssim_fwd_launch takes with seg > 0 (at r != 5 with its
// dynamic shared memory at r). Returns a cudaError_t.
extern "C" int ssim_fwd_stream_occupancy(int mode, int relaxed, int is_float, int r,
                                         int* blocks_per_sm) {
  if (r != kStreamR) {
    return relaxed ? ssim_fwd_stream_rt_relaxed_occupancy(mode, is_float, r, blocks_per_sm)
                   : ssim_fwd_stream_rt_occupancy(mode, is_float, r, blocks_per_sm);
  }
#define SSIM_FWD_OCC(M, S)                                                \
  case M:                                                                 \
    return is_float ? stream_occupancy<float, M, S>(blocks_per_sm)        \
                    : stream_occupancy<uint8_t, M, S>(blocks_per_sm);
  if (relaxed) {
    switch (mode) {
      SSIM_FWD_OCC(kScore, kStreamSplit)
      SSIM_FWD_OCC(kMap, kStreamSplit)
      SSIM_FWD_OCC(kComponents, kStreamSplit)
      SSIM_FWD_OCC(kPooled, kStreamSplit)
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch (mode) {
    SSIM_FWD_OCC(kScore, 0)
    SSIM_FWD_OCC(kMap, 0)
    SSIM_FWD_OCC(kRowsum, 0)
    SSIM_FWD_OCC(kRowsumMap, 0)
    SSIM_FWD_OCC(kPrecise, 0)
    SSIM_FWD_OCC(kPreciseMap, 0)
    SSIM_FWD_OCC(kComponents, 0)
    SSIM_FWD_OCC(kPooled, 0)
    default:
      return cudaErrorInvalidValue;
  }
#undef SSIM_FWD_OCC
}
