// K6: the exact sequential engine (the reference's block scan) on the card.
//
// Not a TPU kernel: the JAX package runs this work as a lax.scan over the
// blocks of a level (mvtools_tpu/analyse.py:801-975 search_level, over
// SearchEngine(lockstep=False) and _pseudo_epz, :247-789), which XLA
// compiles.  It is a kernel of the port because no composition of torch
// ops can run a sequential scan of 10^4 dependent steps on the card: each
// block's left, up and up-right predictors are the vectors written moments
// earlier in the same pass (pobFetchPredictors PlaneOfBlocks.cpp:419-463),
// a meander scan runs every other row backwards, and the rescue's threshold
// `found_sad > badsad + badsad * badcount / 16` reads a count of every
// earlier block's rescue.  So the scan over a job's blocks stays serial.
//
// Design: a CTA of GROUPS warps (8) a job walks the level's blocks in scan
// order, as the C walks them; jobs are independent, so they spread over the
// SMs.  The lever is inside a block: the candidates of one search STEP do
// not depend on each other (the seven predictor trials of pobPseudoEPZSearch
// :819-968, a hexagon ring, an expanding ring, an nstep step, the UMH cross
// and its 16-point scales, one ring of the ring rescue), and every cost,
// motion distortion + SAD (+ penalty), depends only on the block's fixed
// predictor and lambda and on the candidate, never on the running best.  So
// a step's candidates are spread over the CTA's warps (a warp a candidate,
// the block's pixels over its lanes, summed by xor shuffles: luma and
// chroma apart, since penaltyNew weights them apart), all their loads in
// flight at once, and then folded in the reference's order: a warp keeps
// the first strict minimum of (cost, index) over its candidates, and after
// one barrier every thread takes the lexicographic minimum over the warps
// and applies it only below the incoming cost.  That is the serial walk's
// result bit for bit (a candidate replaces the best only at a strictly
// lower cost; one out of bounds is skipped and not counted).  A calm block
// of HEX2 at searchparam 2 is three dependent steps (the trials, the
// hexagon, the expanding ring) instead of some 21 dependent candidates.
// 8 warps: the steps of a calm block hold 7, 6 and 8 candidates, each one
// round of loads; more warps would idle, fewer would take two rounds.
//
// Per block the CTA stages the source block (luma, and U and V with chroma)
// in shared memory once.  A lane reads 4 bytes at a time (4 uint8 or 2
// uint16 pixels, from the aligned words around them) and sums them with
// one __vsadu4 / __vsadu2.  Every thread computes the same block context
// and search state and keeps them in registers, so each branch is uniform
// over the CTA; the search is inlined into one path, and only the rare
// refines (trymany's seven, Recalculate's item) are out of line, taking
// and giving the state by value (a copy of it a thread in local memory
// overflowed L1 at 256 threads and tripled a step's time).  Thread 0
// writes the block's vector; a later block reads it after a barrier,
// except the block just finished, whose vector every thread keeps in
// registers (the left predictor, and the up or up-right one where the
// scan turns).  A step's partial results sit in one of two shared buffers
// by step parity, so one barrier a step suffices.
//
// A second entry point, exact_search_kernel, serves Recalculate's exact
// path (pobRecalculateMVs PlaneOfBlocks.cpp:1158-1424; the JAX package's
// per-block engine, mvtools_tpu/recalculate.py:191-230): one warp per
// (job, block) item, the same step code with one group, no neighbour; the
// block starts at its clipped predictor with the plain SAD there as its
// cost, refines, and keeps the refined vector only if that SAD exceeds
// thsad.
//
// Arithmetic that must match the JAX package bit for bit: the motion
// distortion's squared distance wraps in int32 and its product with lambda
// is cast back to int (pobMotionDistorsion :104-114), computed here in
// unsigned types and cast, since signed overflow is undefined in C++; the
// lambda adaptation (:461-462) is float64 with __dmul_rn / __dadd_rn /
// __ddiv_rn, so that no FMA contraction changes a bit, truncated to int64.
// A candidate block's window start is clamped into the plane the way the
// JAX window slice clamps it.
//
// Costs: the plain SAD (dct 0) of uint8 or uint16 pixels.  Bound on this
// card: neither bytes nor operations.  A serial scan is latency-bound: each
// step is a round of loads, a five-step shuffle sum, a barrier and a fold
// that the next step waits for (at least an L2 load and a CTA round:
// experiments/k6_timing.py measures both and gives the bound in steps).
//
// A host build (g++ -x c++, no __CUDACC__) runs the same code with the
// CTA's threads as loops: MVT_THREADS threads (default 256) in groups of
// min(32, MVT_THREADS) lanes, each group's candidates and each lane's
// pixels taken by the same partition as on the card, the fold the same
// code; the tests build it at 1 and at 256 threads.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MVT_DEV __device__ __forceinline__
#define MVT_HD __host__ __device__ __forceinline__
#define MVT_CALL __device__ __noinline__
#define MVT_LDG(ptr) __ldg(ptr)
#else
#include <vector>
#define MVT_DEV inline
#define MVT_HD inline
#define MVT_CALL
#define MVT_LDG(ptr) (*(ptr))
#define __constant__
#endif
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#ifndef MVT_THREADS
#define MVT_THREADS 256
#endif

namespace mvt_exact {

// the level scan's CTA: THREADS threads in GROUPS groups of LANES lanes
constexpr int THREADS = MVT_THREADS;
#ifdef __CUDACC__
constexpr int LANES = 32;
static_assert(THREADS % 32 == 0 && THREADS <= 1024,
              "the level scan's CTA is whole warps");
#else
constexpr int LANES = THREADS < 32 ? THREADS : 32;
static_assert(THREADS > 0 && THREADS % LANES == 0,
              "MVT_THREADS: 1 to 32, or a multiple of 32");
#endif
constexpr int GROUPS = THREADS / LANES;

// the launch's ints, in the order of ops/exact_scan.py::PARAM_NAMES
enum {
    P_JOBS, P_U16, P_NSUB, P_H, P_W, P_HC, P_WC, P_NBX, P_NBY, P_BSX, P_BSY,
    P_BCX, P_BCY, P_OVX, P_OVY, P_LOGX, P_LOGY, P_HPAD, P_VPAD, P_HPAD_C,
    P_VPAD_C, P_PW, P_PH, P_LOGP, P_BOUND_X, P_BOUND_Y, P_CHROMA, P_SEARCH,
    P_PARAM, P_PZERO, P_PGLOBAL, P_BADSAD, P_BADRANGE, P_TRYMANY, P_MEANDER,
    P_LSAD, P_LAMBDA, P_PNEW, P_VERYBIG, P_SMALLEST, P_THSAD, P_COUNT
};

struct Params {
    int v[P_COUNT];
    MVT_HD int operator[](int i) const { return v[i]; }
};

enum { ONETIME, NSTEP, LOGARITHMIC, EXHAUSTIVE, HEX2, UMH, HORIZONTAL,
       VERTICAL };
constexpr int NO_DIR = INT_MIN;
constexpr long long INF = 1LL << 62;

struct State {
    int bx, by;
    long long bsad, mincost;
    int dir;
};

// a group's best candidate of a step, and how many it evaluated
struct Slot {
    long long cost, sad;
    int idx, count;
};

// a trial's luma and chroma (U + V) SADs
struct Sums {
    long long ls, cs;
};

constexpr int MAX_TRIALS = 8;

// a team's shared memory: a slot per group in two buffers by step parity,
// the trials' sums in two buffers by block parity
template <int NG>
struct TeamMem {
    Slot slot[2][NG];
    Sums trial[2][MAX_TRIALS];
};

// this thread's group and lane (the host build runs every group and lane
// itself and ignores them)
struct Lane {
    int g, lane;
};

template <int NG>
MVT_DEV void team_sync() {
#ifdef __CUDACC__
    if (NG > 1) __syncthreads();
    else __syncwarp();
#endif
}

// A build with -DMVT_PHASES (experiments/k6_timing.py --phases) adds up,
// in thread 0 of every CTA, the clock cycles between successive marks of
// the level scan by phase (MVT_MARK(k): the cycles since the previous
// mark go to phase k); mvt_exact_phases reads and clears the sums.
#if defined(__CUDACC__) && defined(MVT_PHASES)
constexpr int N_PHASES = 8;
__device__ unsigned long long mvt_phase_cycles[N_PHASES];
__shared__ long long mvt_phase_last;     // thread 0's previous mark
#define MVT_MARK(k)                                                          \
    do {                                                                     \
        if (threadIdx.x == 0) {                                              \
            const long long now = clock64();                                 \
            atomicAdd(&mvt_phase_cycles[k],                                  \
                      (unsigned long long)(now - mvt_phase_last));           \
            mvt_phase_last = now;                                            \
        }                                                                    \
    } while (0)
#else
#define MVT_MARK(k) \
    do {            \
    } while (0)
#endif

#ifdef __CUDACC__
MVT_DEV void warp_sum2(int& a, int& b) {
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
    }
}
#endif

// min(max(v, lo), hi), as jnp.clip and torch.clamp take it: hi where the
// bounds cross (a block with no valid vector)
MVT_DEV int clampi(int v, int lo, int hi) {
    v = v < lo ? lo : v;
    return v > hi ? hi : v;
}

MVT_DEV int ilog2(int v) {
    int r = 0;
    while ((1 << r) < v) ++r;
    return r;
}

MVT_DEV double dmul(double a, double b) {
#ifdef __CUDACC__
    return __dmul_rn(a, b);
#else
    return a * b;
#endif
}
MVT_DEV double dadd(double a, double b) {
#ifdef __CUDACC__
    return __dadd_rn(a, b);
#else
    return a + b;
#endif
}
MVT_DEV double ddiv(double a, double b) {
#ifdef __CUDACC__
    return __ddiv_rn(a, b);
#else
    return a / b;
#endif
}

// the hexagon walk (pobHex2Search): entry d + 1 is direction d's step
__constant__ int HEX_X[8] = {-1, -2, -1, 1, 2, 1, -1, -2};
__constant__ int HEX_Y[8] = {-2, 0, 2, 2, 0, -2, -2, 0};
__constant__ int HEX_M6[8] = {5, 0, 1, 2, 3, 4, 5, 0};
__constant__ int UMH_X[16] = {-4, -4, -4, -4, -4, 4, 4, 4, 4, 4, 2, 0,
                                    -2, -2, 0, 2};
__constant__ int UMH_Y[16] = {2, 1, 0, -1, -2, -2, -1, 0, 1, 2, 3, 4, 3,
                                    -3, -4, -3};
// pobNStepSearch's eight neighbours, in its order
__constant__ int NSTEP_X[8] = {1, 1, 1, 0, 0, -1, -1, -1};
__constant__ int NSTEP_Y[8] = {1, 0, -1, -1, 1, 1, 0, -1};
// pobDiamondSearch's diagonals by switch case of the last direction, in
// case order: 0 (+,+), 1 (-,+), 2 (+,-), 3 (-,-); -1 ends a case
__constant__ int DIAMOND_CASES[16][4] = {
    {0, 1, 2, 3}, {0, 2, -1, -1}, {1, 3, -1, -1}, {0, 1, 2, 3},
    {0, 1, -1, -1}, {0, 1, 2, -1}, {0, 1, 3, -1}, {0, 1, 2, 3},
    {2, 3, -1, -1}, {0, 3, 2, -1}, {3, 1, 2, -1}, {0, 1, 2, 3},
    {0, 1, 2, 3}, {0, 1, 2, 3}, {0, 1, 2, 3}, {0, 1, 2, 3}};
__constant__ int DIAG_X[4] = {1, -1, 1, -1};
__constant__ int DIAG_Y[4] = {1, 1, -1, -1};
__constant__ int DIAG_DIR[4] = {5, 6, 9, 10};

// One search step: its candidates, a function of (kind, index) and the
// step's fixed centre, so that a group finds its own candidates and the
// fold the winner's vector without a list in memory.
enum { S_RINGS, S_HEX, S_NSTEP, S_LINE, S_UMH, S_LIST };

struct Step {
    int kind, n, cx, cy;
    int a, b, s;   // RINGS: rings a..b, spacing s; HEX: first table entry;
                   // NSTEP: length; LINE: axis (0 x, 1 y); UMH: range
    bool penalty, update_xy;
    int lx[4], ly[4], ld[4];   // LIST: up to four vectors and directions
};

// a[k] by selects, so that an array indexed by a thread's group stays in
// registers
template <int N>
MVT_DEV int pick(const int (&a)[N], int k) {
    int v = a[0];
#ifdef __CUDACC__
#pragma unroll
#endif
    for (int i = 1; i < N; ++i) v = k == i ? a[i] : v;
    return v;
}

// the count of i in [-r + s, r) step s: one side of an expanding ring
MVT_DEV int ring_side(int r, int s) { return (2 * r + s - 1) / s - 1; }

MVT_DEV int ring_size(int r, int s) { return 4 * ring_side(r, s) + 4; }

// candidate c of step d, in the reference's order
MVT_DEV void candidate(const Step& d, int c, int& vx, int& vy, int& dirv) {
    dirv = NO_DIR;
    switch (d.kind) {
    case S_RINGS: {     // pobExpandingSearch, rings a..b around (cx, cy)
        int r = d.a;
        while (c >= ring_size(r, d.s)) c -= ring_size(r++, d.s);
        const int n1 = ring_side(r, d.s);
        if (c < 2 * n1) {
            vx = d.cx - r + d.s * (1 + (c >> 1));
            vy = (c & 1) ? d.cy + r : d.cy - r;
        } else if (c < 4 * n1) {
            c -= 2 * n1;
            vx = (c & 1) ? d.cx + r : d.cx - r;
            vy = d.cy - r + d.s * (1 + (c >> 1));
        } else {
            c -= 4 * n1;
            vx = c < 2 ? d.cx - r : d.cx + r;
            vy = (c & 1) ? d.cy + r : d.cy - r;
        }
        break;
    }
    case S_HEX:         // the hexagon (a = 1) or three of its points
        vx = d.cx + HEX_X[d.a + c];
        vy = d.cy + HEX_Y[d.a + c];
        dirv = d.a - 1 + c;
        break;
    case S_NSTEP:
        vx = d.cx + NSTEP_X[c] * d.a;
        vy = d.cy + NSTEP_Y[c] * d.a;
        break;
    case S_LINE: {      // (-1, +1, -2, +2, ...) along one axis
        const int i = (c & 1) ? 1 + (c >> 1) : -(1 + (c >> 1));
        vx = d.a ? d.cx : d.cx + i;
        vy = d.a ? d.cy + i : d.cy;
        break;
    }
    case S_UMH: {       // the cross of odd offsets, then the 16-point scales
        const int nc = d.a > 1 ? d.a / 2 : 0;
        if (c < 4 * nc) {
            const int i = ((c & 1) ? 1 : -1) * (1 + 2 * ((c % (2 * nc)) >> 1));
            vx = c < 2 * nc ? d.cx + i : d.cx;
            vy = c < 2 * nc ? d.cy : d.cy + i;
        } else {
            c -= 4 * nc;
            const int scale = c / 16 + 1, k = c % 16;
            vx = d.cx + UMH_X[k] * scale;
            vy = d.cy + UMH_Y[k] * scale;
        }
        break;
    }
    default:            // S_LIST
        vx = pick(d.lx, c);
        vy = pick(d.ly, c);
        dirv = pick(d.ld, c);
        break;
    }
}

// the block trials of one step: luma positions, which to evaluate, which
// take their chroma at (0, 0) (the zero trial)
struct Trials {
    int n;
    unsigned eval, czero;
    int x[MAX_TRIALS], y[MAX_TRIALS];
};

// the four CheckMV0 predictors of a block
struct Preds {
    int x[4], y[4];
};

struct PlaneGeo {
    int h, w, bw, bh, lbw, n;   // plane, block, log2 block width, pixels
    // the block read in units of 4 bytes (4 uint8 or 2 uint16 pixels)
    // where its rows hold whole units, else of one pixel: log2 pixels a
    // unit, log2 units a row, units
    int lppu, lupr, nu;
};

// A unit of pixels that starts at p: one pixel, or the 4 bytes from p
// (uint8 x 4, uint16 x 2) as one word, read as the aligned words around
// them (an aligned word that holds a pixel of a tensor lies in a mapped
// page).  ldg: a load through the read-only path (global memory only).
template <typename T, bool LDG>
MVT_DEV unsigned load_unit(const T* p, int lppu) {
#ifdef __CUDACC__
    if (!lppu) return LDG ? (unsigned)__ldg(p) : (unsigned)*p;
    const size_t a = (size_t)p;
    const unsigned* w = (const unsigned*)(a & ~(size_t)3);
    const int shift = (int)(a & 3) * 8;
    const unsigned lo = LDG ? __ldg(w) : *w;
    const unsigned hi = shift ? (LDG ? __ldg(w + 1) : w[1]) : lo;
    return __funnelshift_r(lo, hi, shift);
#else
    if (!lppu) return (unsigned)*p;
    unsigned v = 0;
    for (int i = 0; i < 4 / (int)sizeof(T); ++i)
        v |= (unsigned)p[i] << (8 * sizeof(T) * i);
    return v;
#endif
}

// the SAD of two units (lppu 0: one pixel each)
template <typename T>
MVT_DEV int sad_unit(unsigned a, unsigned b, int lppu) {
    if (!lppu) return a > b ? (int)(a - b) : (int)(b - a);
#ifdef __CUDACC__
    return sizeof(T) == 1 ? (int)__vsadu4(a, b) : (int)__vsadu2(a, b);
#else
    int sum = 0;
    const int bits = 8 * sizeof(T);
    const unsigned mask = (1u << bits) - 1;
    for (int i = 0; i < 32 / bits; ++i) {
        const int x = (int)((a >> (bits * i)) & mask);
        const int y = (int)((b >> (bits * i)) & mask);
        sum += x > y ? x - y : y - x;
    }
    return sum;
#endif
}

// this job's planes of one kind ([h, w] each, or [n_sub, h, w] with n_sub)
template <typename T>
MVT_DEV void job_planes(const Params& p, const T* const* in, int job,
                        int n_sub, const T** out) {
    const size_t hw = (size_t)p[P_H] * p[P_W];
    const size_t hwc = (size_t)p[P_HC] * p[P_WC];
    for (int pl = 0; pl < 3; ++pl)
        out[pl] = pl < (p[P_CHROMA] ? 3 : 1)
                  ? in[pl] + (size_t)job * n_sub * (pl ? hwc : hw) : nullptr;
}

// One job's planes and parameters and one block's search context: what
// every thread of a team reads.  Each thread computes its own copy, which
// the inlined search keeps in registers; one thread also writes it to the
// team's shared copy, which the out-of-line refine reads (a copy a thread
// in local memory, which is what a call needs, overflows L1 at 256
// threads).
template <typename T>
struct Ctx {
    PlaneGeo geo[2];        // luma, chroma
    int nplanes, logp, pelm, nsub, lx, ly;
    int search, param, trymany, pzero, pglobal, badsad, badrange, pnew;
    long long verybig;
    const T* ref[3];        // this job's reference stacks [n_sub, h, w]
    const T* sb[3];         // the block's source pixels, rows ss[pl] apart
    int ss[3];
    int x0, y0, xc, yc;
    int dxmin, dxmax, dymin, dymax;
    int pred_x, pred_y;
    long long lam;

    MVT_DEV void init(const Params& p, const T* const* r, int job) {
        nplanes = p[P_CHROMA] ? 3 : 1;
        logp = p[P_LOGP];
        pelm = (1 << logp) - 1;
        nsub = p[P_NSUB];
        lx = p[P_LOGX];
        ly = p[P_LOGY];
        search = p[P_SEARCH];
        param = p[P_PARAM];
        trymany = p[P_TRYMANY];
        pzero = p[P_PZERO];
        pglobal = p[P_PGLOBAL];
        badsad = p[P_BADSAD];
        badrange = p[P_BADRANGE];
        pnew = p[P_PNEW];
        verybig = p[P_VERYBIG];
        for (int pl = 0; pl < 2; ++pl) {
            PlaneGeo& g = geo[pl];
            g.h = pl ? p[P_HC] : p[P_H];
            g.w = pl ? p[P_WC] : p[P_W];
            g.bw = pl ? p[P_BCX] : p[P_BSX];
            g.bh = pl ? p[P_BCY] : p[P_BSY];
            g.lbw = ilog2(g.bw);
            g.n = g.bw * g.bh;
            const int ppu = 4 / (int)sizeof(T);
            g.lppu = g.bw % ppu ? 0 : ilog2(ppu);
            g.lupr = g.lbw - g.lppu;
            g.nu = g.n >> g.lppu;
        }
        job_planes(p, r, job, nsub, ref);
        for (int pl = 0; pl < 3; ++pl) {
            sb[pl] = nullptr;
            ss[pl] = 0;
        }
    }

    MVT_DEV void place(const Params& p, int blkx, int blky) {
        x0 = p[P_HPAD] + (p[P_BSX] - p[P_OVX]) * blkx;
        y0 = p[P_VPAD] + (p[P_BSY] - p[P_OVY]) * blky;
        xc = p[P_HPAD_C] + ((p[P_BSX] - p[P_OVX]) >> p[P_LOGX]) * blkx;
        yc = p[P_VPAD_C] + ((p[P_BSY] - p[P_OVY]) >> p[P_LOGY]) * blky;
        dxmin = -((x0 - p[P_BOUND_X]) << logp);
        dxmax = ((p[P_PW] - p[P_BSX] - p[P_BOUND_X]) - x0) << logp;
        dymin = -((y0 - p[P_BOUND_Y]) << logp);
        dymax = ((p[P_PH] - p[P_BSY] - p[P_BOUND_Y]) - y0) << logp;
    }

    // the source block's pixels read where they lie in the planes `src`
    // (this job's [h, w] planes)
    MVT_DEV void source_in_plane(const T* const* src) {
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int pl = 0; pl < 3; ++pl) {
            if (pl >= nplanes) break;
            const PlaneGeo& g = geo[pl ? 1 : 0];
            sb[pl] = src[pl] + (size_t)(pl ? yc : y0) * g.w + (pl ? xc : x0);
            ss[pl] = g.w;
        }
    }

    // the source block copied from the planes `src` into `stage` (each
    // plane's block row after row, the planes one after another) by
    // threads first, first + stride, ...; read from there once the team
    // has passed a barrier
    MVT_DEV void stage_source(const T* const* src, T* stage, int first,
                              int stride) {
        T* out = stage;
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int pl = 0; pl < 3; ++pl) {
            if (pl >= nplanes) break;
            const PlaneGeo& g = geo[pl ? 1 : 0];
            const T* in = src[pl] + (size_t)(pl ? yc : y0) * g.w
                          + (pl ? xc : x0);
            for (int q = first; q < g.n; q += stride)
                out[q] = in[(size_t)(q >> g.lbw) * g.w + (q & (g.bw - 1))];
            sb[pl] = out;
            ss[pl] = g.bw;
            out += g.n;
        }
    }

    MVT_DEV void clip(int& x, int& y) const {
        x = clampi(x, dxmin, dxmax - 1);
        y = clampi(y, dymin, dymax - 1);
    }

    MVT_DEV bool ok(int vx, int vy) const {
        return vx >= dxmin && vy >= dymin && vx < dxmax && vy < dymax;
    }

    MVT_DEV long long motion_distortion(int vx, int vy) const {
        const unsigned dx = (unsigned)pred_x - (unsigned)vx;
        const unsigned dy = (unsigned)pred_y - (unsigned)vy;
        const int dist = (int)(dx * dx + dy * dy);
        const long long prod = (long long)((unsigned long long)lam
                                           * (unsigned long long)(long long)dist);
        return (long long)(int)(unsigned)(unsigned long long)(prod >> 8);
    }

    // plane pl's reference block at pel position (block origin << logp)
    // + v: its first pixel in the job's reference stack
    MVT_DEV const T* window(int pl, int vx, int vy) const {
        const PlaneGeo& g = geo[pl ? 1 : 0];
        const int bx = pl ? xc : x0, by = pl ? yc : y0;
        const int xa = (bx << logp) + vx, ya = (by << logp) + vy;
        const int sub = clampi((xa & pelm) | ((ya & pelm) << logp), 0,
                               nsub - 1);
        const int row = clampi(ya >> logp, 0, g.h - g.bh);
        const int col = clampi(xa >> logp, 0, g.w - g.bw);
        return ref[pl] + ((size_t)sub * g.h + row) * g.w + col;
    }

    // one lane's luma and chroma (U + V) shares of candidate v's SAD: the
    // units lane, lane + nl, ... of the luma block, then of U, then of V,
    // read SHARE at a time (all their loads in flight together); chroma at
    // the chroma position of the luma vector (the division by the
    // subsampling ratio truncates toward zero), or at (0, 0)
    MVT_DEV void lane_sums(int vx, int vy, bool czero, int lane, int nl,
                           int& ls, int& cs) const {
        constexpr int SHARE = 4;
        int tx = 0, ty = 0;
        if (!czero) {
            tx = (vx + (vx < 0 ? (1 << lx) - 1 : 0)) >> lx;
            ty = (vy + (vy < 0 ? (1 << ly) - 1 : 0)) >> ly;
        }
        const bool chroma = nplanes > 1;
        const T* r0 = window(0, vx, vy);
        const T* r1 = chroma ? window(1, tx, ty) : r0;
        const T* r2 = chroma ? window(2, tx, ty) : r0;
        // the planes' numbers in registers, chosen by selects below
        const PlaneGeo g0 = geo[0], g1 = geo[1];
        const T *s0 = sb[0], *s1 = sb[1], *s2 = sb[2];
        const int ss0 = ss[0], ss1 = ss[1];
        const int n0 = g0.nu, n1 = chroma ? g1.nu : 0, total = n0 + 2 * n1;
        ls = cs = 0;
        for (int first = lane; first < total; first += SHARE * nl) {
            unsigned rv[SHARE], sv[SHARE];
#ifdef __CUDACC__
#pragma unroll
#endif
            for (int k = 0; k < SHARE; ++k) {
                const int q = first + k * nl;
                rv[k] = sv[k] = 0;
                if (q < total) {
                    const int pl = q < n0 ? 0 : q < n0 + n1 ? 1 : 2;
                    const int qq = q - (pl ? n0 + (pl - 1) * n1 : 0);
                    const int lupr = pl ? g1.lupr : g0.lupr;
                    const int lppu = pl ? g1.lppu : g0.lppu;
                    const int y = qq >> lupr;
                    const int x = (qq & ((1 << lupr) - 1)) << lppu;
                    const T* r = pl == 0 ? r0 : pl == 1 ? r1 : r2;
                    const T* sp = pl == 0 ? s0 : pl == 1 ? s1 : s2;
                    rv[k] = load_unit<T, true>(
                        r + (size_t)y * (pl ? g1.w : g0.w) + x, lppu);
                    sv[k] = load_unit<T, false>(
                        sp + y * (pl ? ss1 : ss0) + x, lppu);
                }
            }
#ifdef __CUDACC__
#pragma unroll
#endif
            for (int k = 0; k < SHARE; ++k) {
                const int q = first + k * nl;
                const int d = sad_unit<T>(rv[k], sv[k],
                                          q < n0 ? g0.lppu : g1.lppu);
                if (q < n0) ls += d;
                else cs += d;
            }
        }
    }
};

// One thread's part of a team's walk: its context (its own copy and the
// team's), the team's shared memory, its lane and its counters.  Every
// thread of the team holds the same search state, so each branch is
// uniform.
template <typename T, int NG>
struct Team {
    const Ctx<T>* c;        // this thread's copy of the context
    const Ctx<T>* cs;       // the team's (for the out-of-line refine)
    TeamMem<NG>* mem;
    Lane me;
    long long n_eval;       // candidate blocks evaluated
    long long n_steps;      // dependent steps walked
    int par;                // the slots' buffer of the next step

    // candidate v's luma and chroma SADs, summed over this group's lanes
    MVT_DEV void sads(const Ctx<T>& cx, int vx, int vy, bool czero,
                      long long& ls, long long& cs) const {
#ifdef __CUDACC__
        int a, b;
        cx.lane_sums(vx, vy, czero, me.lane, 32, a, b);
        warp_sum2(a, b);
        ls = a;
        cs = b;
#else
        ls = cs = 0;
        for (int l = 0; l < LANES; ++l) {
            int a, b;
            cx.lane_sums(vx, vy, czero, l, LANES, a, b);
            ls += a;
            cs += b;
        }
#endif
    }

    // One step of pobCheckMV calls: every group evaluates its candidates
    // (index g, g + NG, ...) and keeps its first strict minimum of cost;
    // after one barrier every thread folds the groups' minima in index
    // order and takes the winner only below the incoming cost.
    MVT_DEV void step(State& st, const Step& d) {
        if (d.n <= 0) return;
        MVT_MARK(4);            // the search's control code
        const Ctx<T>& cx = *c;
        const int buf = par;
#ifdef __CUDACC__
        {
            const int g = me.g;
#else
        for (int g = 0; g < NG; ++g) {
#endif
            Slot mine{INF, 0, -1, 0};
            for (int k = g; k < d.n; k += NG) {
                int vx, vy, dv;
                candidate(d, k, vx, vy, dv);
                if (!cx.ok(vx, vy)) continue;
                ++mine.count;
                long long ls, cs;
                sads(cx, vx, vy, false, ls, cs);
                long long cost = cx.motion_distortion(vx, vy) + ls + cs;
                if (d.penalty)
                    cost += ((cx.pnew * ls) >> 8) + ((cx.pnew * cs) >> 8);
                if (cost < mine.cost) {
                    mine.cost = cost;
                    mine.sad = ls + cs;
                    mine.idx = k;
                }
            }
#ifdef __CUDACC__
            if (me.lane == 0) mem->slot[buf][g] = mine;
#else
            mem->slot[buf][g] = mine;
#endif
        }
        MVT_MARK(5);            // a step's evaluation
        team_sync<NG>();
        MVT_MARK(6);            // its barrier
        Slot best = mem->slot[buf][0];
        long long count = best.count;
#ifdef __CUDACC__
#pragma unroll
#endif
        for (int g = 1; g < NG; ++g) {
            const Slot s = mem->slot[buf][g];
            count += s.count;
            if (s.idx >= 0 && (best.idx < 0 || s.cost < best.cost
                               || (s.cost == best.cost && s.idx < best.idx)))
                best = s;
        }
        n_eval += count;
        ++n_steps;
        par ^= 1;
        if (best.idx >= 0 && best.cost < st.mincost) {
            int vx, vy, dv;
            candidate(d, best.idx, vx, vy, dv);
            if (d.update_xy) { st.bx = vx; st.by = vy; }
            st.bsad = best.sad;
            st.mincost = best.cost;
            if (dv != NO_DIR) st.dir = dv;
        }
        MVT_MARK(7);            // its fold
    }

    // A step of block trials: their SADs (no bounds check) into the
    // buffer tb of the team's trial sums, read after one barrier.
    MVT_DEV void trials(const Trials& t, int tb) {
        const Ctx<T>& cx = *c;
#ifdef __CUDACC__
        {
            const int g = me.g;
#else
        for (int g = 0; g < NG; ++g) {
#endif
            for (int k = g; k < t.n; k += NG) {
                if (!((t.eval >> k) & 1u)) continue;
                long long ls, cs;
                sads(cx, pick(t.x, k), pick(t.y, k), (t.czero >> k) & 1u, ls,
                     cs);
#ifdef __CUDACC__
                if (me.lane == 0) mem->trial[tb][k] = Sums{ls, cs};
#else
                mem->trial[tb][k] = Sums{ls, cs};
#endif
            }
        }
        MVT_MARK(2);            // the trials' evaluation
        team_sync<NG>();
        MVT_MARK(3);            // their barrier
        ++n_steps;
        for (int k = 0; k < t.n; ++k) n_eval += (t.eval >> k) & 1u;
    }

    MVT_DEV static Step around(int kind, int n, int cx, int cy, int a) {
        Step d;
        d.kind = kind;
        d.n = n;
        d.cx = cx;
        d.cy = cy;
        d.a = a;
        d.b = a;
        d.s = 1;
        d.penalty = true;
        d.update_xy = true;
        return d;
    }

    // pobExpandingSearch for every ring r = a..b with spacing s around
    // (cx, cy): one step (the centre is fixed for all of them)
    MVT_DEV void rings(State& st, int a, int b, int s, int cx, int cy) {
        if (a > b) return;
        Step d = around(S_RINGS, 0, cx, cy, a);
        d.b = b;
        d.s = s;
        for (int r = a; r <= b; ++r) d.n += ring_size(r, s);
        step(st, d);
    }

    // up to four checks with their directions
    MVT_DEV void list(State& st, int n, const int (&v)[4][3]) {
        Step d = around(S_LIST, n, 0, 0, 0);
        for (int k = 0; k < 4; ++k) {
            d.lx[k] = v[k][0];
            d.ly[k] = v[k][1];
            d.ld[k] = v[k][2];
        }
        step(st, d);
    }

    MVT_DEV void nstep(State& st, int stp) {
        for (int ln = stp; ln > 0; --ln)
            step(st, around(S_NSTEP, 8, st.bx, st.by, ln));
    }

    MVT_DEV void onetime(State& st, int ln) {
        st.dir = 0;
        const int dx0 = st.bx, dy0 = st.by;
        list(st, 2, {{dx0 - ln, dy0, 2}, {dx0 + ln, dy0, 1}, {}, {}});
        int sign = st.dir == 2 ? -1 : 1, d = dx0;
        st.dir = st.dir != 0;
        while (st.dir != 0) {
            st.dir = 0;
            d += sign * ln;
            list(st, 1, {{d + sign * ln, dy0, 1}, {}, {}, {}});
        }
        const int dx1 = d;
        st.dir = 0;
        list(st, 2, {{dx1, dy0 - ln, 2}, {dx1, dy0 + ln, 1}, {}, {}});
        sign = st.dir == 2 ? -1 : 1;
        d = dy0;
        st.dir = st.dir != 0;
        while (st.dir != 0) {
            st.dir = 0;
            d += sign * ln;
            list(st, 1, {{dx1, d + sign * ln, 1}, {}, {}, {}});
        }
    }

    MVT_DEV void diamond(State& st, int ln) {
        const int R = 1, L = 2, D = 4, U = 8;
        st.dir = 15;
        while (st.dir > 0) {
            const int dx = st.bx, dy = st.by, last = st.dir;
            st.dir = 0;
            int v[4][3] = {};
            int n = 0;
            const int arms[4][3] = {{dx + ln, dy, R}, {dx - ln, dy, L},
                                    {dx, dy + ln, D}, {dx, dy - ln, U}};
            for (int k = 0; k < 4; ++k)
                if (last & arms[k][2]) {
                    v[n][0] = arms[k][0];
                    v[n][1] = arms[k][1];
                    v[n++][2] = arms[k][2];
                }
            list(st, n, v);
            if (st.dir != 0) {
                const int last2 = st.dir, dx2 = st.bx, dy2 = st.by;
                if (last2 & (R + L))
                    list(st, 2, {{dx2, dy2 + ln, D}, {dx2, dy2 - ln, U}, {},
                                 {}});
                else
                    list(st, 2, {{dx2 + ln, dy2, R}, {dx2 - ln, dy2, L}, {},
                                 {}});
            } else {
                const int c4 = clampi(last, 0, 15);
                n = 0;
                for (int k = 0; k < 4; ++k) {
                    const int o = DIAMOND_CASES[c4][k];
                    if (o < 0) break;
                    v[n][0] = dx + DIAG_X[o] * ln;
                    v[n][1] = dy + DIAG_Y[o] * ln;
                    v[n++][2] = DIAG_DIR[o];
                }
                list(st, n, v);
            }
        }
    }

    MVT_DEV void hex2(State& st, int rng) {
        if (rng > 1) {
            int bmx = st.bx, bmy = st.by;
            st.dir = -2;
            Step d = around(S_HEX, 6, bmx, bmy, 1);
            d.update_xy = false;
            step(st, d);
            if (st.dir != -2) {
                bmx += HEX_X[st.dir + 1];
                bmy += HEX_Y[st.dir + 1];
                for (int i = 1; i < rng / 2 && c->ok(bmx, bmy) && st.dir != -2;
                     ++i) {
                    d = around(S_HEX, 3, bmx, bmy, HEX_M6[st.dir + 1]);
                    d.update_xy = false;
                    st.dir = -2;
                    step(st, d);
                    if (st.dir != -2) {
                        bmx += HEX_X[st.dir + 1];
                        bmy += HEX_Y[st.dir + 1];
                    }
                }
            }
            st.bx = bmx;
            st.by = bmy;
        }
        rings(st, 1, 1, 1, st.bx, st.by);
    }

    // pobUMHSearch: the cross and every scale around (cx, cy) in one step,
    // then the hexagon walk
    MVT_DEV void umh(State& st, int rng, int cx, int cy) {
        const int nc = rng > 1 ? rng / 2 : 0;
        const int scales = rng / 4 > 1 ? rng / 4 : 1;
        step(st, around(S_UMH, 4 * nc + 16 * scales, cx, cy, rng));
        hex2(st, rng);
    }

    MVT_DEV void refine(State& st, int search, int param) {
        switch (search) {
        case ONETIME:
            for (int i = param; i > 0; i /= 2) onetime(st, i);
            break;
        case NSTEP:
            nstep(st, param);
            break;
        case LOGARITHMIC:
            for (int i = param; i > 0; i /= 2) diamond(st, i);
            break;
        case EXHAUSTIVE:
            rings(st, 1, param, 1, st.bx, st.by);
            break;
        case HEX2:
            hex2(st, param);
            break;
        case UMH:
            umh(st, param, st.bx, st.by);
            break;
        case HORIZONTAL:
        case VERTICAL:
            if (param > 0)
                step(st, around(S_LINE, 2 * param, st.bx, st.by,
                                search == VERTICAL));
            break;
        }
    }

    // A refine that is not inlined (trymany's seven, Recalculate's item):
    // every other search code is inlined into one path, so that the team
    // and the state stay in registers; here both go in and out by value.
    struct Refined {
        Team tm;
        State st;
    };

    MVT_CALL static Refined refine_call(Team tm, State st, int search,
                                        int param) {
        tm.refine(st, search, param);
        return Refined{tm, st};
    }

    MVT_DEV State refined(State st, int search, int param) {
        const Refined r = refine_call(Team{cs, cs, mem, me, n_eval, n_steps,
                                           par}, st, search, param);
        n_eval = r.tm.n_eval;
        n_steps = r.tm.n_steps;
        par = r.tm.par;
        return r.st;
    }

    // pobPseudoEPZSearch with trymany: each trial refined in turn, the
    // first of the seven results at the lowest cost taken
    MVT_DEV State try_many(int zs, int gxc, int gyc, int prx, int pry,
                            Preds pr, unsigned eval, int tb) {
        const Sums* sums = mem->trial[tb];
        const int search = c->search, param = c->param;
        const long long verybig = c->verybig;
        const long long sad0 = sums[0].ls + sums[0].cs;
        State st{0, zs, sad0, sad0 + (((long long)c->pzero * sad0) >> 8), 0};
        State res[7];
        int nres = 0;
        st = refined(st, search, param);
        res[nres++] = st;
        const long long sad_g = sums[1].ls + sums[1].cs;
        st.bx = gxc; st.by = gyc; st.bsad = sad_g;
        st.mincost = sad_g + (((long long)c->pglobal * sad_g) >> 8);
        st = refined(st, search, param);
        res[nres++] = st;
        const long long sad_p = sums[2].ls + sums[2].cs;
        st.bx = prx; st.by = pry; st.bsad = sad_p; st.mincost = sad_p;
        st = refined(st, search, param);
        res[nres++] = st;
        for (int i = 0; i < 4; ++i) {
            st.mincost = verybig + 1;
            if ((eval >> (3 + i)) & 1u) {
                const long long sad = sums[3 + i].ls + sums[3 + i].cs;
                const long long cost =
                    c->motion_distortion(pr.x[i], pr.y[i]) + sad;
                if (cost < st.mincost) {
                    st.bx = pr.x[i]; st.by = pr.y[i];
                    st.bsad = sad; st.mincost = cost;
                }
            }
            st = refined(st, search, param);
            res[nres++] = st;
        }
        int k = 0;
        for (int i = 1; i < nres; ++i)
            if (res[i].mincost < res[k].mincost) k = i;
        if (res[k].mincost < verybig + 1) {
            st.bx = res[k].bx; st.by = res[k].by;
            st.bsad = res[k].bsad; st.mincost = res[k].mincost;
        }
        return st;
    }

    // the bad-SAD rescue (PlaneOfBlocks.cpp:938-963) of a block whose SAD
    // `found` is over the threshold
    MVT_DEV State rescue(State st, long long found) {
        const int pelf = 1 << c->logp, badrange = c->badrange;
        if (badrange > 0) {
            umh(st, badrange * pelf, 0, 0);
        } else if (badrange < 0) {
            for (int i = 1; i < -badrange * pelf; i += pelf) {
                rings(st, i, i, pelf, 0, 0);
                if (st.bsad < found / 4) break;
            }
        }
        rings(st, 1, pelf - 1, 1, st.bx, st.by);
        return st;
    }

    // pobPseudoEPZSearch (PlaneOfBlocks.cpp:819-968) at predictor (prx,
    // pry); pr: the four CheckMV0 predictors (median, left, up, up-right
    // or below-right).  The seven trials are one step; their folds keep
    // the reference's order and rules.
    MVT_DEV State pseudo_epz(int zs, int gx, int gy, int prx, int pry,
                             const Preds& pr, int blkidx, int& badcount,
                             int tb) {
        const int gxc = clampi(gx, c->dxmin, c->dxmax - 1);
        const int gyc = clampi(gy, c->dymin, c->dymax - 1);
        // zero trial (no bounds check, chroma at (0, 0)), global trial,
        // main predictor, then the CheckMV0 predictors that are in bounds
        Trials t;
        t.n = 7;
        t.eval = 7u;
        t.czero = 1u;
        t.x[0] = 0; t.y[0] = zs;
        t.x[1] = gxc; t.y[1] = gyc;
        t.x[2] = prx; t.y[2] = pry;
        t.x[7] = t.y[7] = 0;
        for (int i = 0; i < 4; ++i) {
            t.x[3 + i] = pr.x[i];
            t.y[3 + i] = pr.y[i];
            if (c->ok(pr.x[i], pr.y[i])) t.eval |= 1u << (3 + i);
        }
        trials(t, tb);
        State st;
        if (c->trymany) {
            st = try_many(zs, gxc, gyc, prx, pry, pr, t.eval, tb);
        } else {
            const Sums* sums = mem->trial[tb];
            const long long sad0 = sums[0].ls + sums[0].cs;
            st = State{0, zs, sad0,
                       sad0 + (((long long)c->pzero * sad0) >> 8), 0};
            const long long sad_g = sums[1].ls + sums[1].cs;
            const long long cost_g =
                sad_g + (((long long)c->pglobal * sad_g) >> 8);
            if (cost_g < st.mincost) {
                st.bx = gxc; st.by = gyc; st.bsad = sad_g;
                st.mincost = cost_g;
            }
            // main predictor, cost the plain SAD
            const long long sad_p = sums[2].ls + sums[2].cs;
            if (sad_p < st.mincost) {
                st.bx = prx; st.by = pry; st.bsad = sad_p; st.mincost = sad_p;
            }
            // the other predictors (CheckMV0: bounds and distortion, no
            // penaltyNew)
            for (int i = 0; i < 4; ++i) {
                if (!((t.eval >> (3 + i)) & 1u)) continue;
                const long long sad = sums[3 + i].ls + sums[3 + i].cs;
                const long long cost =
                    c->motion_distortion(pr.x[i], pr.y[i]) + sad;
                if (cost < st.mincost) {
                    st.bx = pr.x[i]; st.by = pr.y[i];
                    st.bsad = sad; st.mincost = cost;
                }
            }
            refine(st, c->search, c->param);
        }
        const long long badsad = c->badsad;
        if (blkidx > 1
            && st.bsad > badsad + badsad * (long long)badcount / 16) {
            st = rescue(st, st.bsad);
            ++badcount;
        }
        return st;
    }
};

MVT_DEV int median3(int a, int b, int c) {
    const int lo = a < b ? a : b, hi = a < b ? b : a;
    const int m = hi < c ? hi : c;
    return lo > m ? lo : m;
}

// the elements of a staged source block
MVT_HD int stage_elems(const Params& p) {
    return p[P_BSX] * p[P_BSY] + (p[P_CHROMA] ? 2 * p[P_BCX] * p[P_BCY] : 0);
}

// One job's level: the blocks in scan order (doPobSearchMVs
// PlaneOfBlocks.cpp:971-1131; the JAX package's search_level step), run by
// every thread of the team (tid of nthreads); thread 0 writes.  shared: two
// contexts the team reads (block by block in turn), stage: the staged
// source block.
template <typename T, int NG>
MVT_DEV void scan_body(const Params& p, const T* const* src,
                       const T* const* ref, int* vx, int* vy, long long* vs,
                       const int* gx, const int* gy, const int* zs,
                       int* badcount_out, long long* n_eval,
                       long long* n_steps, int job, Ctx<T>* shared,
                       TeamMem<NG>* mem, T* stage, Lane me, int tid,
                       int nthreads) {
    // this thread's copy of the context; thread 0 copies it to the team's
    Ctx<T> c;
    c.init(p, ref, job);
    const T* jsrc[3];
    job_planes(p, src, job, 1, jsrc);
    const int nbx = p[P_NBX], nby = p[P_NBY], nblk = nbx * nby;
    vx += (size_t)job * nblk;
    vy += (size_t)job * nblk;
    vs += (size_t)job * nblk;
    const int z = zs[job], jgx = gx[job], jgy = gy[job];
    const double lsad = (double)p[P_LSAD];
    int badcount = 0;
    long long evals = 0, steps = 0;
    // the block just finished: its vector, which thread 0 may not have
    // written yet where another thread reads it
    int last = -1, last_x = 0, last_y = 0;
    long long last_s = 0;
    // a block's vector (every load issued, the last block's taken from
    // registers)
    auto vec = [&](int idx, int& x, int& y, long long& sad) {
        const int lx = vx[idx], ly = vy[idx];
        const long long ls = vs[idx];
        const bool mine = idx == last;
        x = mine ? last_x : lx;
        y = mine ? last_y : ly;
        sad = mine ? last_s : ls;
    };
    for (int i = 0; i < nblk; ++i) {
        const int blky = i / nbx, iblkx = i % nbx;
        const bool fwd = !p[P_MEANDER] || blky % 2 == 0;
        const int sdir = fwd ? 1 : -1;
        const int blkx = fwd ? iblkx : nbx - 1 - iblkx;
        const int blkidx = blky * nbx + blkx;
        c.place(p, blkx, blky);
        c.stage_source(jsrc, stage, tid, nthreads);
        // predictors (pobFetchPredictors PlaneOfBlocks.cpp:419-463); a
        // missing neighbour is (0, field shift) with SAD 0
        const bool left_ok = sdir == 1 ? blkx > 0 : blkx < nbx - 1;
        const bool up_ok = blky > 0;
        const bool x_ok = sdir == 1 ? blkx < nbx - 1 : blkx > 0;
        const bool below = blky < nby - 1 && x_ok;
        const bool third = below || (up_ok && x_ok);
        int p1x, p1y, p2x, p2y, p3x, p3y, ownx, owny;
        long long p1s, p2s, p3s, owns;
        vec(left_ok ? blkidx - sdir : blkidx, p1x, p1y, p1s);
        vec(up_ok ? blkidx - nbx : blkidx, p2x, p2y, p2s);
        vec(below ? blkidx + nbx + sdir
                  : third ? blkidx - nbx + sdir : blkidx, p3x, p3y, p3s);
        vec(blkidx, ownx, owny, owns);
        if (!left_ok) { p1x = 0; p1y = z; p1s = 0; }
        if (!up_ok) { p2x = 0; p2y = z; p2s = 0; }
        if (!third) { p3x = 0; p3y = z; p3s = 0; }
        c.clip(p1x, p1y);
        c.clip(p2x, p2y);
        c.clip(p3x, p3y);
        int p0x = p1x, p0y = p1y;
        long long p0s = p1s;
        if (up_ok) {
            p0x = median3(p1x, p2x, p3x);
            p0y = median3(p1y, p2y, p3y);
            p0s = p1s > p2s ? p1s : p2s;
            p0s = p0s > p3s ? p0s : p3s;
        }
        int prx, pry;
        long long prs;
        if (p[P_SMALLEST]) {
            prx = p0x; pry = p0y; prs = p0s;
        } else {
            prx = ownx; pry = owny; prs = owns;
            c.clip(prx, pry);
        }
        // lambda adaptation in C doubles, truncated toward zero
        const double lam0 = blky == 0 ? 0.0 : (double)p[P_LAMBDA];
        const double scale = ddiv(lsad, dadd(lsad, (double)(prs >> 1)));
        c.lam = (long long)dmul(dmul(lam0, scale), scale);
        c.pred_x = prx;
        c.pred_y = pry;
        const Preds preds{{p0x, p1x, p2x, p3x}, {p0y, p1y, p2y, p3y}};
        // a slow thread may still read the other context (the block
        // before), never this one (two blocks before, behind a barrier)
        Ctx<T>& sc = shared[i & 1];
        if (tid == 0) sc = c;
        MVT_MARK(0);            // the block's predictors and staging
        team_sync<NG>();        // the context and the staged source block
        MVT_MARK(1);
        Team<T, NG> tm{&c, &sc, mem, me, 0, 0, 0};
        const State st = tm.pseudo_epz(z, jgx, jgy, prx, pry, preds, blkidx,
                                       badcount, i & 1);
        evals += tm.n_eval;
        steps += tm.n_steps;
        MVT_MARK(4);
        if (tid == 0) {
            vx[blkidx] = st.bx;
            vy[blkidx] = st.by;
            vs[blkidx] = st.bsad;
        }
        last = blkidx;
        last_x = st.bx;
        last_y = st.by;
        last_s = st.bsad;
    }
    if (tid == 0) {
        badcount_out[job] = badcount;
        if (n_eval) n_eval[job] = evals;
        if (n_steps) n_steps[job] = steps;
    }
}

// One (job, block) item of Recalculate's exact search, run by every lane
// of a one-group team (lane 0 writes the context it reads).
template <typename T>
MVT_DEV void item_body(const Params& p, const T* const* src,
                       const T* const* ref, const int* px, const int* py,
                       int* ox, int* oy, long long* os, int* n_eval,
                       long long item, Ctx<T>* shared, TeamMem<1>* mem,
                       Lane me) {
    const int nbx = p[P_NBX], nblk = nbx * p[P_NBY];
    const int job = (int)(item / nblk), b = (int)(item % nblk);
    Ctx<T> c;
    c.init(p, ref, job);
    const T* jsrc[3];
    job_planes(p, src, job, 1, jsrc);
    const int blkx = b % nbx, blky = b / nbx;
    c.place(p, blkx, blky);
    c.source_in_plane(jsrc);
    int cpx = px[item], cpy = py[item];
    c.clip(cpx, cpy);
    c.pred_x = cpx;
    c.pred_y = cpy;
    c.lam = blky == 0 ? 0 : (long long)p[P_LAMBDA];
    if (me.lane == 0) *shared = c;
    team_sync<1>();
    Team<T, 1> tm{&c, shared, mem, me, 0, 0, 0};
    Trials t;
    t.n = 1;
    t.eval = 1u;
    t.czero = 0u;
    for (int k = 0; k < MAX_TRIALS; ++k) t.x[k] = t.y[k] = 0;
    t.x[0] = cpx;
    t.y[0] = cpy;
    tm.trials(t, 0);
    const long long sad0 = mem->trial[0][0].ls + mem->trial[0][0].cs;
    State st{cpx, cpy, sad0, sad0, 0};
    if (sad0 > (long long)p[P_THSAD])
        st = tm.refined(st, p[P_SEARCH], p[P_PARAM]);
    if (me.lane == 0) {
        ox[item] = st.bx;
        oy[item] = st.by;
        os[item] = st.bsad;
        if (n_eval) n_eval[item] = (int)tm.n_eval;
    }
}

#ifdef __CUDACC__
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
exact_scan_kernel(Params p, const T* sy, const T* su, const T* sv,
                  const T* ry, const T* ru, const T* rv, int* vx, int* vy,
                  long long* vs, const int* gx, const int* gy, const int* zs,
                  int* badcount, long long* n_eval, long long* n_steps) {
    __shared__ Ctx<T> ctx[2];
    __shared__ TeamMem<GROUPS> mem;
    extern __shared__ __align__(16) unsigned char stage[];
    const T* src[3] = {sy, su, sv};
    const T* ref[3] = {ry, ru, rv};
    const int tid = threadIdx.x;
#ifdef MVT_PHASES
    if (tid == 0) mvt_phase_last = clock64();
#endif
    scan_body<T, GROUPS>(p, src, ref, vx, vy, vs, gx, gy, zs, badcount,
                         n_eval, n_steps, blockIdx.x, ctx, &mem, (T*)stage,
                         Lane{tid >> 5, tid & 31}, tid, THREADS);
}

constexpr int ITEM_WARPS = 4;

template <typename T>
__global__ void __launch_bounds__(32 * ITEM_WARPS)
exact_search_kernel(Params p, const T* sy, const T* su, const T* sv,
                    const T* ry, const T* ru, const T* rv, const int* px,
                    const int* py, int* ox, int* oy, long long* os,
                    int* n_eval, long long n_items) {
    __shared__ Ctx<T> ctx[ITEM_WARPS];
    __shared__ TeamMem<1> mem[ITEM_WARPS];
    const int w = threadIdx.x >> 5;
    const long long item = (long long)blockIdx.x * ITEM_WARPS + w;
    if (item >= n_items) return;        // whole warps leave together
    const T* src[3] = {sy, su, sv};
    const T* ref[3] = {ry, ru, rv};
    item_body<T>(p, src, ref, px, py, ox, oy, os, n_eval, item, &ctx[w],
                 &mem[w], Lane{0, (int)threadIdx.x & 31});
}
#else
// The host forms: the team's groups and lanes as loops.
template <typename T>
void scan_job(const Params& p, const T* const* src, const T* const* ref,
              int* vx, int* vy, long long* vs, const int* gx, const int* gy,
              const int* zs, int* badcount_out, long long* n_eval, int job,
              long long* n_steps = nullptr) {
    Ctx<T> ctx[2];
    TeamMem<GROUPS> mem;
    std::vector<T> stage(stage_elems(p));
    scan_body<T, GROUPS>(p, src, ref, vx, vy, vs, gx, gy, zs, badcount_out,
                         n_eval, n_steps, job, ctx, &mem, stage.data(),
                         Lane{0, 0}, 0, 1);
}

template <typename T>
void search_item(const Params& p, const T* const* src, const T* const* ref,
                 const int* px, const int* py, int* ox, int* oy,
                 long long* os, int* n_eval, long long item) {
    Ctx<T> ctx;
    TeamMem<1> mem;
    item_body<T>(p, src, ref, px, py, ox, oy, os, n_eval, item, &ctx, &mem,
                 Lane{0, 0});
}
#endif

}  // namespace mvt_exact

#ifdef __CUDACC__
using namespace mvt_exact;

static bool params_ok(const int* a) {
    const int pow2[] = {a[P_BSX], a[P_BSY], a[P_BCX], a[P_BCY]};
    for (int v : pow2)
        if (v < 1 || (v & (v - 1))) return false;
    return a[P_JOBS] >= 0 && (a[P_U16] == 0 || a[P_U16] == 1)
           && a[P_NSUB] == 1 << (2 * a[P_LOGP]) && a[P_LOGP] >= 0
           && a[P_LOGP] <= 2 && a[P_NBX] > 0 && a[P_NBY] > 0
           && a[P_H] >= a[P_BSY] && a[P_W] >= a[P_BSX]
           && (!a[P_CHROMA] || (a[P_HC] >= a[P_BCY] && a[P_WC] >= a[P_BCX]))
           && a[P_SEARCH] >= ONETIME && a[P_SEARCH] <= VERTICAL;
}

template <typename T>
static int launch_scan(const Params& p, const void* const* s,
                       const void* const* r, void* vx, void* vy, void* vs,
                       const void* gx, const void* gy, const void* zs,
                       void* badcount, void* n_eval, void* n_steps,
                       cudaStream_t st) {
    const size_t smem = (size_t)stage_elems(p) * sizeof(T);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            exact_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    exact_scan_kernel<T><<<p[P_JOBS], THREADS, smem, st>>>(
        p, (const T*)s[0], (const T*)s[1], (const T*)s[2], (const T*)r[0],
        (const T*)r[1], (const T*)r[2], (int*)vx, (int*)vy, (long long*)vs,
        (const int*)gx, (const int*)gy, (const int*)zs, (int*)badcount,
        (long long*)n_eval, (long long*)n_steps);
    return (int)cudaGetLastError();
}

// The level scan: a CTA of THREADS threads per job; vx/vy/vs are read and
// written in place.  n_eval, n_steps (may be null): the candidate blocks
// each job evaluated and the dependent steps it walked.
extern "C" int mvt_exact_scan(const void* sy, const void* su, const void* sv,
                              const void* ry, const void* ru, const void* rv,
                              void* vx, void* vy, void* vs, const void* gx,
                              const void* gy, const void* zs,
                              void* badcount, void* n_eval, void* n_steps,
                              const int* a, void* stream) {
    if (!params_ok(a)) return (int)cudaErrorInvalidValue;
    if (a[P_JOBS] == 0) return 0;
    Params p;
    for (int i = 0; i < P_COUNT; ++i) p.v[i] = a[i];
    const void* s[3] = {sy, su, sv};
    const void* r[3] = {ry, ru, rv};
    cudaStream_t st = (cudaStream_t)stream;
    return a[P_U16]
        ? launch_scan<uint16_t>(p, s, r, vx, vy, vs, gx, gy, zs, badcount,
                                n_eval, n_steps, st)
        : launch_scan<uint8_t>(p, s, r, vx, vy, vs, gx, gy, zs, badcount,
                               n_eval, n_steps, st);
}

#ifdef MVT_PHASES
// the phases' summed cycles since the last read (N_PHASES of them), then
// cleared
extern "C" int mvt_exact_phases(unsigned long long* out) {
    cudaError_t e = cudaMemcpyFromSymbol(out, mvt_phase_cycles,
                                         sizeof(mvt_phase_cycles));
    if (e == cudaSuccess) {
        const unsigned long long zero[N_PHASES] = {};
        e = cudaMemcpyToSymbol(mvt_phase_cycles, zero, sizeof(zero));
    }
    return (int)e;
}
#endif

// Recalculate's exact search: one warp per (job, block) item.  n_eval (may
// be null): the candidate blocks each item evaluated.
extern "C" int mvt_exact_search(const void* sy, const void* su,
                                const void* sv, const void* ry,
                                const void* ru, const void* rv,
                                const void* px, const void* py, void* ox,
                                void* oy, void* os, void* n_eval,
                                const int* a, void* stream) {
    if (!params_ok(a)) return (int)cudaErrorInvalidValue;
    const long long n = (long long)a[P_JOBS] * a[P_NBX] * a[P_NBY];
    if (n == 0) return 0;
    if ((n + ITEM_WARPS - 1) / ITEM_WARPS > INT_MAX)
        return (int)cudaErrorInvalidValue;
    Params p;
    for (int i = 0; i < P_COUNT; ++i) p.v[i] = a[i];
    cudaStream_t st = (cudaStream_t)stream;
    const unsigned blocks = (unsigned)((n + ITEM_WARPS - 1) / ITEM_WARPS);
#define MVT_K6I(T)                                                           \
    exact_search_kernel<T><<<blocks, 32 * ITEM_WARPS, 0, st>>>(              \
        p, (const T*)sy, (const T*)su, (const T*)sv, (const T*)ry,           \
        (const T*)ru, (const T*)rv, (const int*)px, (const int*)py,          \
        (int*)ox, (int*)oy, (long long*)os, (int*)n_eval, n)
    if (a[P_U16]) MVT_K6I(uint16_t);
    else MVT_K6I(uint8_t);
#undef MVT_K6I
    return (int)cudaGetLastError();
}
#endif
