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
//   the image repairs that.) Both modes stream rows at radius 5 (below),
//   in the relaxed tier too; other radii run the tile body.
// - kBatch / kBatchPrecise (the small-image batch route): one partial
//   pair per image, [sum(ssim - 1), n = H*W], f32 in kBatch (the JAX
//   contract's (B, 2)) and f64 in kBatchPrecise (where the TPU writes
//   (B, 3) [hi, lo, n]; both are summed in f64 by the finalize). Each
//   pixel's SSIM is kScore's (kPrecise's) bit for bit. At radius 5 both
//   run the packed row stream (ssim_fwd_batch_stream_kernel in
//   ssim_fwd_batch.cu, one block a strip of a packed row): the
//   TPU packs p images along one lane row and folds their borders into
//   block-diagonal tap matrices; here k images lie side by side in a
//   packed row cut into 128-column strips, and each image's piece of a
//   strip is staged with its own clamped columns; the relaxed kBatch too
//   (its heavy blurs as band products, ssim_fwd_batch.cu). Other radii
//   keep the tile body: it runs over each image's own grid of
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
//   kComponents and kPooled at radius 5 stream rows (ssim_fwd_stream_kernel,
//   below), and kBatch streams packed rows (ssim_fwd_batch.cu); other
//   radii and tiles run the tile body, which makes
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
// other radii, keeps twice the planes' bytes in shared memory), plus the
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
// type Blur<kMode>), and relaxed kScore, kMap, kComponents and kPooled
// (kSplit > 0, below), at radius kStreamR = 5 (windows.RADIUS, every
// main-path shape and MS-SSIM scale) and tiles up to kStripW columns wide;
// kBatch (either tier) and kBatchPrecise at radius kStreamR run its steps
// (b)-(d) over packed rows of images (ssim_fwd_batch_stream_kernel,
// ssim_fwd_batch.cu); every other radius and tile keeps the tile body
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
// (29.1 KB of shared memory, 7 blocks per SM, 72 registers: a window of
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

// The row modes' second pass: each row's ntx pieces added in order, in
// double, rounded to f32, plus W in f32 (rows + w, ssim_pallas.py:1328-1330).
// One thread per row.
__global__ void rowsum_reduce_kernel(const float* __restrict__ pieces,
                                     float* __restrict__ rows, int B, int ntx,
                                     int H, float w) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * H) return;
  const int img = (int)(i / H);
  const int y = (int)(i - (long long)img * H);
  const float* p = pieces + (size_t)img * ntx * (size_t)H + (size_t)y;
  double s = 0.0;
  for (int t = 0; t < ntx; ++t) s += p[(size_t)t * H];
  rows[i] = (float)s + w;
}

}  // namespace

// ---------------------------------------------------------------------------
// The main-path modes: row-streaming column strips.
// Their constants and steps (b)-(d), which the batch modes' packed
// stream shares (ssim_fwd_batch.cu), are in fwd_stream.cuh.

#include "fwd_stream.cuh"

namespace {

// kScore / kMap: partials (B, nty * ntx) f32 as the tile body writes them
// (kSplit > 0: the relaxed modes, kSplit = kStreamSplit); kPrecise /
// kPreciseMap: the same in f64, the blurs, formula and sums in fp64
// (Blur<kMode>); kRowsum / kRowsumMap: pieces (B, ntx, H) f32, each tile's
// piece of each of its rows, for rowsum_reduce_kernel; kComponents /
// kPooled: partials (B, nty * ntx, 2) f32, [sum(cs - 1), sum(ssim - 1)] +
// n_valid, and in kPooled the 2x2-mean images pool_a, pool_b (B, H/2, W/2)
// f32 of the block's own rows and columns (TH even). TH x TW: the tile (TW
// a power of two in [32, kStripW]); S: the segment's rows (a multiple of TH,
// at most kMaxSegTiles tiles).
template <typename T, int kMode, int kSplit = 0>
__global__ void __launch_bounds__(kStreamThreads, kStreamBlocksOf<kMode, kSplit>)
ssim_fwd_stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       Blur<kMode>* __restrict__ partials, float* __restrict__ map,
                       float* __restrict__ pieces, Halo<T> halo, int H, int W,
                       int TH, int TW, int S, int nstrip, int nseg, int ntx,
                       int nty, StreamTaps<Blur<kMode>> tp, Blur<kMode> c1,
                       Blur<kMode> c2, float clip_bound, float* __restrict__ pool_a,
                       float* __restrict__ pool_b) {
  using P = Blur<kMode>;
  constexpr int r = kStreamR;
  constexpr int kP = 2 * r + 1;  // window rows = steps unrolled
  constexpr int kNT = kStreamThreads;
  constexpr int kInW = kStreamInW;
  constexpr int kLoads = (kInW + kNT - 1) / kNT;
  constexpr bool kFloat = sizeof(T) == 4;
  constexpr bool kWithMap = kMode == kMap || kMode == kRowsumMap || kMode == kPreciseMap;
  constexpr bool kRows = kMode == kRowsum || kMode == kRowsumMap;
  constexpr int kRing = kStreamRingOf<kMode>;  // signals in the shared ring
  constexpr bool kRelaxed = kSplit > 0;
  constexpr bool kComp = kMode == kComponents || kMode == kPooled;
  constexpr bool kPool = kMode == kPooled;
  // Signals in registers (relaxed: mu_a and mu_b; the other two are read
  // from the blurred rows' ring).
  constexpr int kRegS = kRelaxed ? 2 : 4 - kRing;
  // Rows staged ahead of the step that blurs them.
  constexpr int kLead = kRelaxed ? 3 : 1;
  static_assert(kMode == kScore || kMode == kMap || kComp ||
                    (!kRelaxed && (kRows || kMode == kPrecise || kMode == kPreciseMap)),
                "main-path, components and precise modes only; relaxed: kScore, kMap, "
                "kComponents and kPooled");
  static_assert(!kRelaxed || kSplit == kStreamSplit, "the band's k-steps at kStreamR");

  __shared__ StagedRow<P> s_in[2];          // staged rows, by step parity
  __shared__ P s_red[2][kNT / 32];          // warp sums, by step parity
  __shared__ unsigned s_bad[kMaxSegTiles];  // bit per tile column, word per tile row
  // The components modes: the cs warp sums, by step parity.
  __shared__ P s_red_cs[kComp ? 2 * (kNT / 32) : 1];
  // kPooled: the raw inputs (unsanitised, in f32) of the strip's own
  // columns, a then b, stream row q in slot q mod 4: step s pools rows
  // s + kLead - 2 and s + kLead - 1 while row s + kLead is staged (slot
  // (s + kLead - 4) mod 4, read at step s - 2 or before).
  __shared__ __align__(16) float s_raw[kPool ? 4 * 2 * kStripW : 1];
  // The window's ring: slot k, signal kRegS + p, this thread's column.
  __shared__ P s_ring[kRing > 0 ? kRing * kP * kNT : 1];
  // Relaxed (instead of s_in): staged row q in slot q mod kStreamStaged of
  // s_ab, followed by the ring, s_hres: the horizontal blurs of (a+b)^2,
  // then of (a-b)^2, of row q in slot q mod kStreamRing, kStripW columns
  // (ring_col) a slot; the band's fragments, per lane (hi then lo, one
  // uint4 per k-step); the taps, for make_band.
  constexpr int kAbFloats = 2 * kStreamStaged * kStreamInW;
  constexpr int kRingFloats = 2 * kStreamRing * kStripW;
  __shared__ __align__(16) float s_rel[kRelaxed ? kAbFloats + kRingFloats : 1];
  [[maybe_unused]] float2* s_ab = reinterpret_cast<float2*>(s_rel);
  [[maybe_unused]] float* s_hres = s_rel + kAbFloats;
  __shared__ uint4 s_band[kRelaxed ? 2 * kSplit * 32 : 1];
  __shared__ float s_taps[kRelaxed ? kP : 1];

  const int tid = threadIdx.x;
  if (tid < kMaxSegTiles) s_bad[tid] = 0u;
  if constexpr (kRelaxed) {
    // Zeros in the columns no row is staged to and in the ring, which
    // row_pass reads past a row's staged columns (times zeros of the band:
    // they must be finite).
    for (int i = tid; i < kAbFloats + kRingFloats; i += kNT) s_rel[i] = 0.0f;
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < kP; ++k) s_taps[k] = tp.t[k];
    }
  }
  // Before the prologue's stage(0), which may mark tiles in s_bad.
  __syncthreads();
  if constexpr (kRelaxed) {
    if (tid < 32) {
      const band_mma::Band<kSplit> bd = band_mma::make_band<kSplit>(s_taps, r);
#pragma unroll
      for (int ks = 0; ks < kSplit; ++ks) {
        s_band[ks * 32 + tid] = make_uint4(bd.hi[ks][0], bd.hi[ks][1], bd.hi[ks][2],
                                           bd.hi[ks][3]);
        s_band[(kSplit + ks) * 32 + tid] = make_uint4(bd.lo[ks][0], bd.lo[ks][1],
                                                      bd.lo[ks][2], bd.lo[ks][3]);
      }
    }
  }

  int blk = blockIdx.x;
  const int strip = blk % nstrip;
  blk /= nstrip;
  const int seg = blk % nseg;
  const int img = blk / nseg;
  const int x0 = strip * kStripW;
  const int y0 = seg * S;
  const int vw = min(kStripW, W - x0);  // valid output columns
  const int vh = min(S, H - y0);        // valid output rows
  const size_t base = (size_t)img * (size_t)H * (size_t)W;
  const int n = vh + 2 * r;  // stream rows: virtual row y0 - r + q
  const bool col_on = tid < vw;  // this thread's output column x0 + tid
  const int tcol = tid / TW;     // its tile column in the strip
  const bool lead = tid == tcol * TW && col_on;  // combines its tile's sums
  const int txg = x0 / TW + tcol;  // its tile column in the image
  const int ty_base = y0 / TH;     // the segment's first tile row

  // Staging: stream row q loaded into registers (fetch), then staged
  // (stage). Staged column j is image column x0 - r + j, clamped.
  T pa[kLoads], pb[kLoads];
  int gxl[kLoads];
#pragma unroll
  for (int q = 0; q < kLoads; ++q) {
    gxl[q] = min(max(x0 - r + tid + q * kNT, 0), W - 1);
  }
  auto fetch = [&](int q) {
    const int vi = y0 - r + q;
    const T* ra;
    const T* rb;
    if (kRows && vi < 0 && halo.at != nullptr && !halo.is_top) {
      const size_t o = ((size_t)img * r + (size_t)(vi + r)) * (size_t)W;
      ra = halo.at + o;
      rb = halo.bt + o;
    } else if (kRows && vi >= H && halo.ab != nullptr && !halo.is_bot) {
      const size_t o = ((size_t)img * r + (size_t)(vi - H)) * (size_t)W;
      ra = halo.ab + o;
      rb = halo.bb + o;
    } else {
      const size_t o = base + (size_t)min(max(vi, 0), H - 1) * (size_t)W;
      ra = a + o;
      rb = b + o;
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (tid + k * kNT < vw + 2 * r) {
        pa[k] = __ldg(ra + gxl[k]);
        pb[k] = __ldg(rb + gxl[k]);
      }
    }
  };
  auto stage = [&](int q) {
    const int ly = q - r;  // the segment's output row this input row is
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int j = tid + k * kNT;
      if (j < vw + 2 * r) {
        float va = to_f32(pa[k]);
        float vb = to_f32(pb[k]);
        if constexpr (kPool) {
          // The pool's source: the strip's own columns, raw (a u8 value
          // converts exactly; an f32 NaN reaches its own pooled pixel).
          const int xo = j - r;
          if (xo >= 0 && xo < vw) {
            float* raw = s_raw + (q & 3) * 2 * kStripW;
            raw[xo] = va;
            raw[kStripW + xo] = vb;
          }
        }
        if (kFloat) {
          // Poison source: the segment's own pixels, unsanitised (rare path).
          if (!(finite_f32(va) && finite_f32(vb))) {
            const int xo = j - r;
            if (ly >= 0 && ly < vh && xo >= 0 && xo < vw) {
              atomicOr(&s_bad[ly / TH], 1u << (xo / TW));
            }
          }
          va = sanitize(va, clip_bound);
          vb = sanitize(vb, clip_bound);
        }
        if constexpr (kRelaxed) {
          s_ab[(q & (kStreamStaged - 1)) * kStreamInW + j] = make_float2(va, vb);
        } else {
          s_in[q & 1].put(j, va, vb);
        }
      }
    }
  };

  // The window: the horizontal blurs of the last 2r + 1 stream rows, per
  // signal, the row of stream index q in slot q mod kP; signals kRegS..3 in
  // the shared ring where it has them. acc: this column's sum(ssim - 1) over
  // the current tile's rows (the tile modes), acc_cs its sum(cs - 1) (the
  // components modes).
  P win[kRegS > 0 ? kRegS : 1][kP];
  auto win_put = [&](int p, int k, P v) {
    if (p >= kRegS) {
      s_ring[(k * kRing + (p - kRegS)) * kNT + tid] = v;
    } else {
      win[p][k] = v;
    }
  };
  auto win_get = [&](int p, int k) -> P {
    return p >= kRegS ? s_ring[(k * kRing + (p - kRegS)) * kNT + tid] : win[p][k];
  };
  P acc = 0;
  [[maybe_unused]] P acc_cs = 0;
  int trow = 0;  // row within the current tile
  int kt = 0;    // the current tile's row in the segment
  // Warp sums waiting in s_red[(s - 1) & 1] for step s to combine: the
  // tile row (tile modes) or the output row (row modes), else -1; and in
  // the row modes the tile row that ended there, else -1.
  int pend = -1, pend_end = -1;

  auto tile_bad = [&](int t) -> bool {
    return kFloat && ((s_bad[t] >> tcol) & 1u);
  };
  // Step s's combine of the warp sums written in step s - 1: the tile's
  // warps in order.
  auto combine = [&](int s) {
    if (pend < 0) return;
    const P* red = s_red[(s - 1) & 1] + tid / 32;
    if (lead) {
      P sum = 0;
      for (int k = 0; k < TW / 32; ++k) sum += red[k];
      if constexpr (kRows) {
        const size_t prow = ((size_t)img * ntx + (size_t)txg) * (size_t)H;
        pieces[prow + (size_t)(y0 + pend)] = sum;
        if (pend_end >= 0 && tile_bad(pend_end)) {
          // The tile ended at this row and holds a non-finite pixel: NaN
          // over its rows' pieces, after their finite writes (this thread's).
          const int ty0 = y0 + pend_end * TH;
          for (int y = ty0; y <= y0 + pend; ++y) {
            pieces[prow + (size_t)y] = __int_as_float(0x7fc00000);
          }
        }
      } else {
        const int tyg = ty_base + pend;
        const int vth = min(TH, H - tyg * TH);
        const int vtw = min(TW, W - txg * TW);
        const P nan = (P)__int_as_float(0x7fc00000);
        if constexpr (kComp) {
          // [sum(cs - 1), sum(ssim - 1)] + n_valid, NaN in both.
          const P* red_cs = s_red_cs + ((s - 1) & 1) * (kNT / 32) + tid / 32;
          P sum_cs = 0;
          for (int k = 0; k < TW / 32; ++k) sum_cs += red_cs[k];
          const bool bad = tile_bad(pend);
          const size_t t = ((size_t)img * nty + (size_t)tyg) * (size_t)ntx + (size_t)txg;
          partials[2 * t] = bad ? nan : sum_cs + (P)(vth * vtw);
          partials[2 * t + 1] = bad ? nan : sum + (P)(vth * vtw);
        } else {
          partials[((size_t)img * nty + (size_t)tyg) * (size_t)ntx + (size_t)txg] =
              tile_bad(pend) ? nan : sum + (P)(vth * vtw);
        }
      }
    }
    pend = -1;
    pend_end = -1;
  };

  // Prologue: stream rows 0 .. kLead - 1 staged, row kLead loading (n >=
  // 2r + 1 rows).
  fetch(0);
  stage(0);
  if constexpr (kRelaxed) {
#pragma unroll
    for (int q = 1; q < kLead; ++q) {
      fetch(q);
      stage(q);
    }
  }
  if (n > kLead) fetch(kLead);
  __syncthreads();
  if constexpr (kRelaxed) {
    // Row 0's heavy blurs, warp p plane p; each even step s then blurs rows
    // s + 1 and s + 2.
    if (tid < 64) {
      const int plane = tid >> 5;
      row_pass<kSplit>(s_ab, s_hres + plane * kStreamRing * kStripW, plane, s_band);
    }
    __syncthreads();
  }

  for (int s0 = 0; s0 < n; s0 += kP) {
    // Relaxed: the ring's slots of rows s0 + d, d >= 0 in hr0 + d, d < 0 in
    // hr1 + d (kStripW floats a slot, this thread's column).
    [[maybe_unused]] const float* hr0 = nullptr;
    [[maybe_unused]] const float* hr1 = nullptr;
    if constexpr (kRelaxed) {
      const int par = (s0 / kP) & 1;
      hr0 = s_hres + (par ? kP : 0) * kStripW + ring_col(tid);
      hr1 = s_hres + (par ? kP : 2 * kP) * kStripW + ring_col(tid);
    }
#pragma unroll
    for (int k = 0; k < kP; ++k) {
      const int s = s0 + k;
      if (s < n) {
        if constexpr (kRelaxed) {
          // Even steps: rows s + 1 and s + 2's heavy blurs into their ring
          // slots, row s + 1 + w / 2's plane w % 2 by warp w. Both rows were
          // staged before the last barrier; steps from s + 1 read them, and
          // each slot's last reader was step s - 2r or earlier.
          if ((s & 1) == 0) {
            const int q = s + 1 + (tid >> 6), plane = (tid >> 5) & 1;
            if (q < n) {
              row_pass<kSplit>(s_ab + (q & (kStreamStaged - 1)) * kStreamInW,
                               s_hres + (plane * kStreamRing + q % kStreamRing) * kStripW,
                               plane, s_band);
            }
          }
        }
        // (a) The warp sums of the step before.
        combine(s);

        // (b) Stream row s: horizontal blur into the window's slot k.
        if constexpr (kIsPrecise<kMode>) {
          // A thread pair blurs two columns: the even thread the (a, b)
          // plane, the odd one the ((a+b)^2, (a-b)^2) plane, each for both
          // columns; then each passes the other its column's half (every
          // lane takes part in the shuffle).
          const StagedRow<P>& row = s_in[s & 1];
          const bool odd = tid & 1;
          double2 o0, o1;
          sym2x2(tp, (odd ? row.sd : row.ab) + (tid & ~1), o0, o1);
          const double2 give = odd ? o0 : o1;
          const double2 got = make_double2(__shfl_xor_sync(0xffffffffu, give.x, 1),
                                           __shfl_xor_sync(0xffffffffu, give.y, 1));
          const double2 ab = odd ? got : o0, sd = odd ? o1 : got;
          if (col_on) {
            win_put(0, k, ab.x);
            win_put(1, k, ab.y);
            win_put(2, k, sd.x);
            win_put(3, k, sd.y);
          }
        } else if (col_on) {
          if constexpr (kRelaxed) {
            // mu_a, mu_b by the f32 symmetric pass ((a+b)^2 and (a-b)^2:
            // row_pass, in the ring).
            float h[2];
            sym2(tp, s_ab + (s & (kStreamStaged - 1)) * kStreamInW + tid + r, h);
            win_put(0, k, h[0]);
            win_put(1, k, h[1]);
          } else {
            const StagedRow<P>& row = s_in[s & 1];
            P h[4];
            sym4(tp, [&](int i) { return row.get(tid + r + i); }, h);
#pragma unroll
            for (int p = 0; p < 4; ++p) win_put(p, k, h[p]);
          }
        }

        // (c) Output row ly = s - 2r from stream rows s - 2r .. s (ages 2r
        // .. 0: the row of age j in slot (k - j) mod kP).
        if (s >= 2 * r) {
          const int ly = s - 2 * r;
          P v = 0;
          [[maybe_unused]] P cs = 0;
          if (col_on) {
            P m[4];
            if constexpr (kRelaxed) {
              sym4(tp,
                   [&](int i) {
                     const int sl = (k - r + i + 2 * kP) % kP;
                     const int d = k - r + i;  // row s0 + d
                     const float* h = (d >= 0 ? hr0 : hr1) + d * kStripW;
                     return Vec4<P>{win_get(0, sl), win_get(1, sl), h[0],
                                    h[kStreamRing * kStripW]};
                   },
                   m);
            } else {
              sym4(tp,
                   [&](int i) {
                     const int sl = (k - r + i + 2 * kP) % kP;
                     return Vec4<P>{win_get(0, sl), win_get(1, sl), win_get(2, sl),
                                    win_get(3, sl)};
                   },
                   m);
            }
            if constexpr (kComp) {
              v = components_of(m, c1, c2, cs);
            } else {
              v = ssim_of(m, c1, c2);
            }
            if (kWithMap) {
              map[base + (size_t)(y0 + ly) * (size_t)W + (size_t)(x0 + tid)] = (float)v;
            }
          }
          const bool tile_end = ++trow == TH || ly == vh - 1;
          if constexpr (kRows) {
            // The tile body's row piece: (ssim - 1) of each column, each
            // warp's 32 columns by shuffles (idle columns add 0).
            const float w = warp_sum(col_on ? v - 1.0f : 0.0f);
            if ((tid & 31) == 0) s_red[s & 1][tid / 32] = w;
            pend = ly;
            pend_end = tile_end ? kt : -1;
          } else {
            if (col_on) {
              acc += v - (P)1;
              if constexpr (kComp) acc_cs += cs - (P)1;
            }
            if (tile_end) {
              const P w = warp_sum(acc);
              if ((tid & 31) == 0) s_red[s & 1][tid / 32] = w;
              if constexpr (kComp) {
                const P wc = warp_sum(acc_cs);
                if ((tid & 31) == 0) s_red_cs[(s & 1) * (kNT / 32) + tid / 32] = wc;
                acc_cs = 0;
              }
              acc = 0;
              pend = kt;
            }
          }
          if (tile_end) {
            if (kWithMap && kFloat && col_on && tile_bad(kt)) {
              // NaN over the tile's map rows in this column, after their
              // finite writes (rare path).
              for (int y = y0 + kt * TH; y <= y0 + ly; ++y) {
                map[base + (size_t)y * (size_t)W + (size_t)(x0 + tid)] =
                    __int_as_float(0x7fc00000);
              }
            }
            trow = 0;
            ++kt;
          }
        }

        if constexpr (kPool) {
          // The 2x2 means of the segment's output rows ly - 1 and ly = s +
          // kLead - 1 - r, the last two rows staged (ly odd; S is even, so
          // pooled row (y0 + ly) / 2 is this block's alone): thread i the
          // strip's columns 2i and 2i + 1. Vertical pairs first, then
          // horizontal, then * 0.25 (ops/pool.downsample2).
          const int ly = s + kLead - 1 - r;
          const int px = x0 / 2 + tid;
          if (ly > 0 && (ly & 1) && ly < vh && tid < kStripW / 2 && px < W / 2) {
            const float* r0 = s_raw + ((s + kLead - 2) & 3) * 2 * kStripW + 2 * tid;
            const float* r1 = s_raw + ((s + kLead - 1) & 3) * 2 * kStripW + 2 * tid;
            const float2 a0 = *reinterpret_cast<const float2*>(r0);
            const float2 a1 = *reinterpret_cast<const float2*>(r1);
            const float2 b0 = *reinterpret_cast<const float2*>(r0 + kStripW);
            const float2 b1 = *reinterpret_cast<const float2*>(r1 + kStripW);
            const size_t o = ((size_t)img * (size_t)(H / 2) + (size_t)((y0 + ly) / 2)) *
                                 (size_t)(W / 2) + (size_t)px;
            pool_a[o] = ((a0.x + a1.x) + (a0.y + a1.y)) * 0.25f;
            pool_b[o] = ((b0.x + b1.x) + (b0.y + b1.y)) * 0.25f;
          }
        }

        // (d) Stream row s + kLead staged from the registers loaded last
        // step; row s + kLead + 1 loaded.
        if (s + kLead < n) {
          stage(s + kLead);
          if (s + (kLead + 1) < n) fetch(s + (kLead + 1));
        }
        __syncthreads();
      }
    }
  }
  combine(n);
}

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
// and 9, relaxed modes 0-3, r = 5, TW in [32, 128], seg a
// multiple of TH of at most 16 tiles; anything else is refused). Returns the
// launch's cudaError_t.
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
        r != kStreamR || TW < 32 ||
        TW > kStripW || seg < TH || seg % TH != 0 || seg / TH > kMaxSegTiles ||
        H < 1 || W < 1) {
      return cudaErrorInvalidValue;
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
// once in `mode` (0-5, 8 or 9; relaxed = 1: 0-3) for uint8
// (is_float = 0) or float32 inputs: the CUDA runtime's occupancy for the
// instantiation that ssim_fwd_launch takes with seg > 0. Returns a
// cudaError_t.
extern "C" int ssim_fwd_stream_occupancy(int mode, int relaxed, int is_float,
                                         int* blocks_per_sm) {
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
