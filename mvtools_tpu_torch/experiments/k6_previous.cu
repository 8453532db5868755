// K6's previous body (the level scan up to its redesign): one warp a job
// that walks a block's candidates one at a time, every lane holding the
// same state, each candidate's SAD summed by xor shuffles.  Kept only so
// that k6_timing.py can time it beside csrc/exact_scan.cu in one call, and
// so that the tests can hold the redesign's candidate counts to it on the
// host: the file is csrc/exact_scan.cu as it was, its namespace and entry
// points renamed (mvt_exact_previous, exact_scan_previous_kernel,
// mvt_exact_scan_previous, ...).  The port does not build it.
//
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
// earlier block's rescue.
//
// Design: one warp per job (frame pair) walks the level's blocks in scan
// order, as the C walks them; jobs are independent, so they spread over the
// SMs (a CTA of one warp a job).  The warp's lanes share each candidate's
// SAD: the block's pixels are spread over the lanes and summed by xor
// shuffles, luma and both chroma planes, so every lane holds the same sum
// and the same search state, and every branch is uniform across the warp.
// The search (pobPseudoEPZSearch :819-968 and pobRefine :772-816 with its
// eight searches) is scalar code in the reference's candidate order: a
// candidate replaces the best only at a strictly lower cost.  The job's
// vector arrays ([nblk] x, y, sad in global memory, which start as the
// inter-level prediction) are read for the predictors and written after
// each block; only this warp touches them, and every lane writes the same
// values, so each lane reads back what it wrote itself.  badcount lives in
// a register.
//
// A second entry point, exact_search_previous_kernel, serves Recalculate's exact
// path (pobRecalculateMVs PlaneOfBlocks.cpp:1158-1424; the JAX package's
// per-block engine, mvtools_tpu/recalculate.py:191-230): one warp per
// (job, block) item, no neighbour; the block starts at its clipped
// predictor with the plain SAD there as its cost, refines, and keeps the
// refined vector only if that SAD exceeds thsad.
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
// Costs: the plain SAD (dct 0) of uint8 or uint16 pixels.  Pixels are
// read straight from global memory (the source block stays in L1 across a
// block's candidates).  Bound on this card: neither bytes nor operations.
// A serial scan is latency-bound: each candidate is a chain of loads, a
// five-step shuffle sum and a compare that the next candidate depends on.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define MVT_DEV __device__ __forceinline__
// the searches and the candidate check are called from many places
// (pseudo_epz refines up to eight times, the rescue walks the UMH): inlined
// everywhere they would make one kernel of some ten thousand SAD loops
#define MVT_CALL __device__ __noinline__
#define MVT_LANES 32
#define MVT_LANE ((int)threadIdx.x & 31)
#else
// A host build of the search code (g++ -x c++): one lane, no shuffles.
#include <cmath>
#include <cstring>
#define MVT_DEV inline
#define MVT_CALL
#define __constant__
#define MVT_LANES 1
#define MVT_LANE 0
#endif
#include <limits.h>
#include <stdint.h>

namespace mvt_exact_previous {

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
    MVT_DEV int operator[](int i) const { return v[i]; }
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

MVT_DEV int warp_sum(int v) {
#ifdef __CUDACC__
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
#endif
    return v;
}

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

// One job's planes and one block's search context.
template <typename T>
struct Search {
    const Params& p;
    const T* src[3];        // this job's source planes [h, w]
    const T* ref[3];        // this job's reference stacks [n_sub, h, w]
    int x0, y0, xc, yc;
    int dxmin, dxmax, dymin, dymax;
    int pred_x, pred_y;
    long long lam;
    mutable long long n_eval = 0;   // candidate blocks evaluated

    MVT_DEV Search(const Params& prm) : p(prm) {}

    // SAD of plane pl's block at full-pel origin (bx, by) of the source
    // against the reference block at pel position (bx << logp) + v
    MVT_CALL int plane_sad(int pl, int bx, int by, int vx, int vy) const {
        const int logp = p[P_LOGP], pelm = (1 << logp) - 1;
        const int h = pl ? p[P_HC] : p[P_H], w = pl ? p[P_WC] : p[P_W];
        const int bw = pl ? p[P_BCX] : p[P_BSX];
        const int bh = pl ? p[P_BCY] : p[P_BSY];
        const int lbw = ilog2(bw);
        const int xa = (bx << logp) + vx, ya = (by << logp) + vy;
        const int sub = clampi((xa & pelm) | ((ya & pelm) << logp), 0,
                               p[P_NSUB] - 1);
        const int row = clampi(ya >> logp, 0, h - bh);
        const int col = clampi(xa >> logp, 0, w - bw);
        const T* r = ref[pl] + ((size_t)sub * h + row) * w + col;
        const T* s = src[pl] + (size_t)by * w + bx;
        int acc = 0;
        for (int q = MVT_LANE; q < bw * bh; q += MVT_LANES) {
            const int y = q >> lbw, x = q & (bw - 1);
            const int d = (int)r[(size_t)y * w + x] - (int)s[(size_t)y * w + x];
            acc += d < 0 ? -d : d;
        }
        return warp_sum(acc);
    }

    MVT_DEV long long luma(int vx, int vy) const {
        ++n_eval;
        return plane_sad(0, x0, y0, vx, vy);
    }

    // U + V at the chroma position of the luma vector (the division by the
    // subsampling ratio truncates toward zero)
    MVT_DEV long long chroma(int vx, int vy) const {
        if (!p[P_CHROMA]) return 0;
        const int lx = p[P_LOGX], ly = p[P_LOGY];
        const int tx = (vx + (vx < 0 ? (1 << lx) - 1 : 0)) >> lx;
        const int ty = (vy + (vy < 0 ? (1 << ly) - 1 : 0)) >> ly;
        return (long long)plane_sad(1, xc, yc, tx, ty)
               + plane_sad(2, xc, yc, tx, ty);
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

    // pobCheckMV: a candidate replaces the best at a strictly lower cost
    MVT_CALL void check(State& st, int vx, int vy, int dirv = NO_DIR,
                       bool penalty = true, bool update_xy = true) const {
        if (!ok(vx, vy)) return;
        const long long ls = luma(vx, vy), cs = chroma(vx, vy);
        const long long sad = ls + cs;
        long long cost = motion_distortion(vx, vy) + sad;
        if (penalty) {
            const long long pn = p[P_PNEW];
            cost += ((pn * ls) >> 8) + ((pn * cs) >> 8);
        }
        if (cost < st.mincost) {
            if (update_xy) { st.bx = vx; st.by = vy; }
            st.bsad = sad;
            st.mincost = cost;
            if (dirv != NO_DIR) st.dir = dirv;
        }
    }

    MVT_CALL void expanding(State& st, int r, int s, int cx, int cy) const {
        for (int i = -r + s; i < r; i += s) {
            check(st, cx + i, cy - r);
            check(st, cx + i, cy + r);
        }
        for (int j = -r + s; j < r; j += s) {
            check(st, cx - r, cy + j);
            check(st, cx + r, cy + j);
        }
        check(st, cx - r, cy - r);
        check(st, cx - r, cy + r);
        check(st, cx + r, cy - r);
        check(st, cx + r, cy + r);
    }

    MVT_CALL void exhaustive(State& st, int radius) const {
        const int cx = st.bx, cy = st.by;
        for (int r = 1; r <= radius; ++r) expanding(st, r, 1, cx, cy);
    }

    MVT_CALL void nstep(State& st, int stp) const {
        for (int ln = stp; ln > 0; --ln) {
            const int dx = st.bx, dy = st.by;
            check(st, dx + ln, dy + ln);
            check(st, dx + ln, dy);
            check(st, dx + ln, dy - ln);
            check(st, dx, dy - ln);
            check(st, dx, dy + ln);
            check(st, dx - ln, dy + ln);
            check(st, dx - ln, dy);
            check(st, dx - ln, dy - ln);
        }
    }

    MVT_CALL void onetime(State& st, int ln) const {
        st.dir = 0;
        const int dx0 = st.bx, dy0 = st.by;
        check(st, dx0 - ln, dy0, 2);
        check(st, dx0 + ln, dy0, 1);
        int sign = st.dir == 2 ? -1 : 1, d = dx0;
        st.dir = st.dir != 0;
        while (st.dir != 0) {
            st.dir = 0;
            d += sign * ln;
            check(st, d + sign * ln, dy0, 1);
        }
        const int dx1 = d;
        st.dir = 0;
        check(st, dx1, dy0 - ln, 2);
        check(st, dx1, dy0 + ln, 1);
        sign = st.dir == 2 ? -1 : 1;
        d = dy0;
        st.dir = st.dir != 0;
        while (st.dir != 0) {
            st.dir = 0;
            d += sign * ln;
            check(st, dx1, d + sign * ln, 1);
        }
    }

    MVT_CALL void diamond(State& st, int ln) const {
        const int R = 1, L = 2, D = 4, U = 8;
        st.dir = 15;
        while (st.dir > 0) {
            const int dx = st.bx, dy = st.by, last = st.dir;
            st.dir = 0;
            if (last & R) check(st, dx + ln, dy, R);
            if (last & L) check(st, dx - ln, dy, L);
            if (last & D) check(st, dx, dy + ln, D);
            if (last & U) check(st, dx, dy - ln, U);
            if (st.dir != 0) {
                const int last2 = st.dir, dx2 = st.bx, dy2 = st.by;
                if (last2 & (R + L)) {
                    check(st, dx2, dy2 + ln, D);
                    check(st, dx2, dy2 - ln, U);
                } else {
                    check(st, dx2 + ln, dy2, R);
                    check(st, dx2 - ln, dy2, L);
                }
            } else {
                const int c = clampi(last, 0, 15);
                for (int k = 0; k < 4; ++k) {
                    const int o = DIAMOND_CASES[c][k];
                    if (o < 0) break;
                    check(st, dx + DIAG_X[o] * ln, dy + DIAG_Y[o] * ln,
                          DIAG_DIR[o]);
                }
            }
        }
    }

    MVT_CALL void hex2(State& st, int rng) const {
        if (rng > 1) {
            int bmx = st.bx, bmy = st.by;
            st.dir = -2;
            check(st, bmx - 2, bmy, 0, true, false);
            check(st, bmx - 1, bmy + 2, 1, true, false);
            check(st, bmx + 1, bmy + 2, 2, true, false);
            check(st, bmx + 2, bmy, 3, true, false);
            check(st, bmx + 1, bmy - 2, 4, true, false);
            check(st, bmx - 1, bmy - 2, 5, true, false);
            if (st.dir != -2) {
                bmx += HEX_X[st.dir + 1];
                bmy += HEX_Y[st.dir + 1];
                for (int i = 1; i < rng / 2 && ok(bmx, bmy) && st.dir != -2;
                     ++i) {
                    const int odir = HEX_M6[st.dir + 1];
                    st.dir = -2;
                    for (int k = 0; k < 3; ++k)
                        check(st, bmx + HEX_X[odir + k], bmy + HEX_Y[odir + k],
                              odir - 1 + k, true, false);
                    if (st.dir != -2) {
                        bmx += HEX_X[st.dir + 1];
                        bmy += HEX_Y[st.dir + 1];
                    }
                }
            }
            st.bx = bmx;
            st.by = bmy;
        }
        expanding(st, 1, 1, st.bx, st.by);
    }

    MVT_CALL void umh(State& st, int rng, int cx, int cy) const {
        for (int i = 1; i < rng; i += 2) {
            check(st, cx - i, cy);
            check(st, cx + i, cy);
        }
        for (int j = 1; j < rng; j += 2) {
            check(st, cx, cy - j);
            check(st, cx, cy + j);
        }
        const int scales = rng / 4 > 1 ? rng / 4 : 1;
        for (int i = 1; i <= scales; ++i)
            for (int k = 0; k < 16; ++k)
                check(st, cx + UMH_X[k] * i, cy + UMH_Y[k] * i);
        hex2(st, rng);
    }

    MVT_CALL void refine(State& st, int search, int param) const {
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
            exhaustive(st, param);
            break;
        case HEX2:
            hex2(st, param);
            break;
        case UMH:
            umh(st, param, st.bx, st.by);
            break;
        case HORIZONTAL: {
            const int cx = st.bx, cy = st.by;
            for (int i = 1; i <= param; ++i) {
                check(st, cx - i, cy);
                check(st, cx + i, cy);
            }
            break;
        }
        case VERTICAL: {
            const int cx = st.bx, cy = st.by;
            for (int i = 1; i <= param; ++i) {
                check(st, cx, cy - i);
                check(st, cx, cy + i);
            }
            break;
        }
        }
    }

    MVT_DEV long long plain_sad(int vx, int vy) const {
        return luma(vx, vy) + chroma(vx, vy);
    }

    // pobPseudoEPZSearch (PlaneOfBlocks.cpp:819-968); preds: the four
    // CheckMV0 predictors (median, left, up, up-right or below-right)
    MVT_CALL State pseudo_epz(int zs, int gx, int gy, int prx, int pry,
                             const int (&preds)[4][2], int blkidx,
                             int& badcount) const {
        const int search = p[P_SEARCH], param = p[P_PARAM];
        const bool trymany = p[P_TRYMANY] != 0;
        const long long verybig = p[P_VERYBIG];
        // zero trial: no bounds check, chroma at (0, 0)
        const long long sad0 = luma(0, zs) + chroma(0, 0);
        State st{0, zs, sad0, sad0 + (((long long)p[P_PZERO] * sad0) >> 8), 0};
        State res[7];
        int nres = 0;
        if (trymany) { refine(st, search, param); res[nres++] = st; }
        // global trial
        const int gxc = clampi(gx, dxmin, dxmax - 1);
        const int gyc = clampi(gy, dymin, dymax - 1);
        const long long sad_g = plain_sad(gxc, gyc);
        const long long cost_g =
            sad_g + (((long long)p[P_PGLOBAL] * sad_g) >> 8);
        if (cost_g < st.mincost || trymany) {
            st.bx = gxc; st.by = gyc; st.bsad = sad_g; st.mincost = cost_g;
        }
        if (trymany) { refine(st, search, param); res[nres++] = st; }
        // main predictor, cost the plain SAD
        const long long sad_p = plain_sad(prx, pry);
        if (sad_p < st.mincost || trymany) {
            st.bx = prx; st.by = pry; st.bsad = sad_p; st.mincost = sad_p;
        }
        if (trymany) { refine(st, search, param); res[nres++] = st; }
        // the other predictors (CheckMV0: bounds and distortion, no
        // penaltyNew)
        for (int i = 0; i < 4; ++i) {
            if (trymany) st.mincost = verybig + 1;
            check(st, preds[i][0], preds[i][1], NO_DIR, false);
            if (trymany) { refine(st, search, param); res[nres++] = st; }
        }
        if (trymany) {
            int k = 0;
            for (int i = 1; i < nres; ++i)
                if (res[i].mincost < res[k].mincost) k = i;
            if (res[k].mincost < verybig + 1) {
                st.bx = res[k].bx; st.by = res[k].by;
                st.bsad = res[k].bsad; st.mincost = res[k].mincost;
            }
        } else {
            refine(st, search, param);
        }
        // bad-SAD rescue (PlaneOfBlocks.cpp:938-963)
        const long long badsad = p[P_BADSAD];
        const long long found = st.bsad;
        if (blkidx > 1 && found > badsad + badsad * (long long)badcount / 16) {
            const int pelf = 1 << p[P_LOGP], badrange = p[P_BADRANGE];
            if (badrange > 0) {
                umh(st, badrange * pelf, 0, 0);
            } else if (badrange < 0) {
                for (int i = 1; i < -badrange * pelf; i += pelf) {
                    expanding(st, i, pelf, 0, 0);
                    if (st.bsad < found / 4) break;
                }
            }
            const int mvx = st.bx, mvy = st.by;
            for (int i = 1; i < pelf; ++i) expanding(st, i, 1, mvx, mvy);
            ++badcount;
        }
        return st;
    }

    MVT_DEV void place(int blkx, int blky) {
        x0 = p[P_HPAD] + (p[P_BSX] - p[P_OVX]) * blkx;
        y0 = p[P_VPAD] + (p[P_BSY] - p[P_OVY]) * blky;
        xc = p[P_HPAD_C] + ((p[P_BSX] - p[P_OVX]) >> p[P_LOGX]) * blkx;
        yc = p[P_VPAD_C] + ((p[P_BSY] - p[P_OVY]) >> p[P_LOGY]) * blky;
        const int logp = p[P_LOGP];
        dxmin = -((x0 - p[P_BOUND_X]) << logp);
        dxmax = ((p[P_PW] - p[P_BSX] - p[P_BOUND_X]) - x0) << logp;
        dymin = -((y0 - p[P_BOUND_Y]) << logp);
        dymax = ((p[P_PH] - p[P_BSY] - p[P_BOUND_Y]) - y0) << logp;
    }

    MVT_DEV void clip(int& x, int& y) const {
        x = clampi(x, dxmin, dxmax - 1);
        y = clampi(y, dymin, dymax - 1);
    }
};

MVT_DEV int median3(int a, int b, int c) {
    const int lo = a < b ? a : b, hi = a < b ? b : a;
    const int m = hi < c ? hi : c;
    return lo > m ? lo : m;
}

template <typename T>
MVT_DEV void set_planes(Search<T>& s, const Params& p, const T* const* src,
                        const T* const* ref, int job) {
    const size_t hw = (size_t)p[P_H] * p[P_W];
    const size_t hwc = (size_t)p[P_HC] * p[P_WC];
    for (int pl = 0; pl < (p[P_CHROMA] ? 3 : 1); ++pl) {
        const size_t n = pl ? hwc : hw;
        s.src[pl] = src[pl] + (size_t)job * n;
        s.ref[pl] = ref[pl] + (size_t)job * p[P_NSUB] * n;
    }
}

// One job's level: the blocks in scan order (doPobSearchMVs
// PlaneOfBlocks.cpp:971-1131; the JAX package's search_level step).
template <typename T>
MVT_DEV void scan_job(const Params& p, const T* const* src,
                      const T* const* ref, int* vx, int* vy, long long* vs,
                      const int* gx, const int* gy, const int* zs,
                      int* badcount_out, long long* n_eval, int job) {
    Search<T> s(p);
    set_planes(s, p, src, ref, job);
    const int nbx = p[P_NBX], nby = p[P_NBY], nblk = nbx * nby;
    vx += (size_t)job * nblk;
    vy += (size_t)job * nblk;
    vs += (size_t)job * nblk;
    const int z = zs[job], jgx = gx[job], jgy = gy[job];
    const double lsad = (double)p[P_LSAD];
    int badcount = 0;
    for (int i = 0; i < nblk; ++i) {
        const int blky = i / nbx, iblkx = i % nbx;
        const bool fwd = !p[P_MEANDER] || blky % 2 == 0;
        const int sdir = fwd ? 1 : -1;
        const int blkx = fwd ? iblkx : nbx - 1 - iblkx;
        const int blkidx = blky * nbx + blkx;
        s.place(blkx, blky);
        // predictors (pobFetchPredictors PlaneOfBlocks.cpp:419-463); a
        // missing neighbour is (0, field shift) with SAD 0
        const bool left_ok = sdir == 1 ? blkx > 0 : blkx < nbx - 1;
        const bool up_ok = blky > 0;
        const bool x_ok = sdir == 1 ? blkx < nbx - 1 : blkx > 0;
        int p1x = 0, p1y = z, p2x = 0, p2y = z, p3x = 0, p3y = z;
        long long p1s = 0, p2s = 0, p3s = 0;
        if (left_ok) {
            const int li = blkidx - sdir;
            p1x = vx[li]; p1y = vy[li]; p1s = vs[li];
        }
        if (up_ok) {
            const int ui = blkidx - nbx;
            p2x = vx[ui]; p2y = vy[ui]; p2s = vs[ui];
        }
        if (blky < nby - 1 && x_ok) {
            const int bi = blkidx + nbx + sdir;
            p3x = vx[bi]; p3y = vy[bi]; p3s = vs[bi];
        } else if (up_ok && x_ok) {
            const int ui = blkidx - nbx + sdir;
            p3x = vx[ui]; p3y = vy[ui]; p3s = vs[ui];
        }
        s.clip(p1x, p1y);
        s.clip(p2x, p2y);
        s.clip(p3x, p3y);
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
            prx = vx[blkidx]; pry = vy[blkidx]; prs = vs[blkidx];
            s.clip(prx, pry);
        }
        // lambda adaptation in C doubles, truncated toward zero
        const double lam0 = blky == 0 ? 0.0 : (double)p[P_LAMBDA];
        const double scale = ddiv(lsad, dadd(lsad, (double)(prs >> 1)));
        s.lam = (long long)dmul(dmul(lam0, scale), scale);
        s.pred_x = prx;
        s.pred_y = pry;
        const int preds[4][2] = {{p0x, p0y}, {p1x, p1y}, {p2x, p2y},
                                 {p3x, p3y}};
        const State st = s.pseudo_epz(z, jgx, jgy, prx, pry, preds, blkidx,
                                      badcount);
        vx[blkidx] = st.bx;
        vy[blkidx] = st.by;
        vs[blkidx] = st.bsad;
    }
    if (MVT_LANE == 0) {
        badcount_out[job] = badcount;
        if (n_eval) n_eval[job] = s.n_eval;
    }
}

// One (job, block) item of Recalculate's exact search.
template <typename T>
MVT_DEV void search_item(const Params& p, const T* const* src,
                         const T* const* ref, const int* px, const int* py,
                         int* ox, int* oy, long long* os, int* n_eval,
                         long long item) {
    const int nbx = p[P_NBX], nblk = nbx * p[P_NBY];
    const int job = (int)(item / nblk), b = (int)(item % nblk);
    Search<T> s(p);
    set_planes(s, p, src, ref, job);
    const int blkx = b % nbx, blky = b / nbx;
    s.place(blkx, blky);
    int cpx = px[item], cpy = py[item];
    s.clip(cpx, cpy);
    s.pred_x = cpx;
    s.pred_y = cpy;
    s.lam = blky == 0 ? 0 : (long long)p[P_LAMBDA];
    const long long sad0 = s.plain_sad(cpx, cpy);
    State st{cpx, cpy, sad0, sad0, 0};
    if (sad0 > (long long)p[P_THSAD]) s.refine(st, p[P_SEARCH], p[P_PARAM]);
    if (MVT_LANE == 0) {
        ox[item] = st.bx;
        oy[item] = st.by;
        os[item] = st.bsad;
        if (n_eval) n_eval[item] = (int)s.n_eval;
    }
}

#ifdef __CUDACC__
template <typename T>
__global__ void __launch_bounds__(32)
exact_scan_previous_kernel(Params p, const T* sy, const T* su, const T* sv,
                  const T* ry, const T* ru, const T* rv, int* vx, int* vy,
                  long long* vs, const int* gx, const int* gy, const int* zs,
                  int* badcount, long long* n_eval) {
    const T* src[3] = {sy, su, sv};
    const T* ref[3] = {ry, ru, rv};
    scan_job<T>(p, src, ref, vx, vy, vs, gx, gy, zs, badcount, n_eval,
                blockIdx.x);
}

constexpr int ITEM_WARPS = 4;

template <typename T>
__global__ void __launch_bounds__(32 * ITEM_WARPS)
exact_search_previous_kernel(Params p, const T* sy, const T* su, const T* sv,
                    const T* ry, const T* ru, const T* rv, const int* px,
                    const int* py, int* ox, int* oy, long long* os,
                    int* n_eval, long long n_items) {
    const long long item =
        (long long)blockIdx.x * ITEM_WARPS + (threadIdx.x >> 5);
    if (item >= n_items) return;        // whole warps leave together
    const T* src[3] = {sy, su, sv};
    const T* ref[3] = {ry, ru, rv};
    search_item<T>(p, src, ref, px, py, ox, oy, os, n_eval, item);
}
#endif

}  // namespace mvt_exact_previous

#ifdef __CUDACC__
using namespace mvt_exact_previous;

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

// The level scan: one warp (a CTA) per job; vx/vy/vs are read and written
// in place.  n_eval (may be null): the candidate blocks each job evaluated.
extern "C" int mvt_exact_scan_previous(const void* sy, const void* su, const void* sv,
                              const void* ry, const void* ru, const void* rv,
                              void* vx, void* vy, void* vs, const void* gx,
                              const void* gy, const void* zs,
                              void* badcount, void* n_eval, const int* a,
                              void* stream) {
    if (!params_ok(a)) return (int)cudaErrorInvalidValue;
    if (a[P_JOBS] == 0) return 0;
    Params p;
    for (int i = 0; i < P_COUNT; ++i) p.v[i] = a[i];
    cudaStream_t st = (cudaStream_t)stream;
#define MVT_K6P(T)                                                            \
    exact_scan_previous_kernel<T><<<a[P_JOBS], 32, 0, st>>>(                          \
        p, (const T*)sy, (const T*)su, (const T*)sv, (const T*)ry,           \
        (const T*)ru, (const T*)rv, (int*)vx, (int*)vy, (long long*)vs,      \
        (const int*)gx, (const int*)gy, (const int*)zs, (int*)badcount,      \
        (long long*)n_eval)
    if (a[P_U16]) MVT_K6P(uint16_t);
    else MVT_K6P(uint8_t);
#undef MVT_K6P
    return (int)cudaGetLastError();
}

// Recalculate's exact search: one warp per (job, block) item.  n_eval (may
// be null): the candidate blocks each item evaluated.
extern "C" int mvt_exact_search_previous(const void* sy, const void* su,
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
#define MVT_K6PI(T)                                                           \
    exact_search_previous_kernel<T><<<blocks, 32 * ITEM_WARPS, 0, st>>>(              \
        p, (const T*)sy, (const T*)su, (const T*)sv, (const T*)ry,           \
        (const T*)ru, (const T*)rv, (const int*)px, (const int*)py,          \
        (int*)ox, (int*)oy, (long long*)os, (int*)n_eval, n)
    if (a[P_U16]) MVT_K6PI(uint16_t);
    else MVT_K6PI(uint8_t);
#undef MVT_K6PI
    return (int)cudaGetLastError();
}
#endif
