/* Native binned-SAH BVH builder.
 *
 * The host-side build is the one part of the pipeline that is inherently
 * serial-recursive and latency-bound, so — like the reference, whose
 * builders are native C++ (tiny_bvh.h:2261-2461) — it is implemented in C
 * and called through ctypes. Same algorithm and SAH rules as
 * builders/binned.py (8-bin centroid binning on 3 axes, cost
 * c_trav + c_int·rSAV·(A_L·N_L + A_R·N_R) vs c_int·count, child AABBs from
 * binned fragment bounds), producing the canonical BVH2 layout:
 * root at node 0, slot 1 reserved, children in adjacent pairs.
 *
 * Single-pass structure (this machine exposes ONE core, so the win is in
 * pass count, not threads): each task carries its centroid bounds computed
 * by its parent's partition loop, child AABBs come from the accumulated bin
 * bounds (as the reference does, tiny_bvh.h:2380-2405), and the partition
 * loop folds the child centroid bounds on the fly — one binning pass + one
 * partition pass per node instead of four scans.
 *
 * Build: cc -O3 -march=native -shared -fPIC builder.c -o libtinybvh.so
 */
#include <float.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef __AVX2__
#include <immintrin.h>
#endif

#define BINS 8
#define C_TRAV 1.0f
#define C_INT 1.0f

static inline float fmin3(float a, float b) { return a < b ? a : b; }
static inline float fmax3(float a, float b) { return a > b ? a : b; }

static inline float half_area(const float *mn, const float *mx) {
    float ex = mx[0] - mn[0], ey = mx[1] - mn[1], ez = mx[2] - mn[2];
    if (ex < 0) ex = 0; if (ey < 0) ey = 0; if (ez < 0) ez = 0;
    return ex * ey + ey * ez + ez * ex;
}

typedef struct {
    const float *fmin;   /* (N,3) fragment bounds */
    const float *fmax;
    const float *cent;   /* (N,3) centroids */
    const float *frag8;  /* (N,8) 32B-aligned [fmin | -fmax | 0 0] rows */
    float *node_min;     /* (M,3) out */
    float *node_max;
    int32_t *left_first;
    int32_t *count;
    int32_t *prim;       /* work permutation, length N */
    int32_t n_used;
    int32_t max_leaf;
} ctx_t;

typedef struct {
    int32_t node, start, cnt;
    float cbmin[3], cbmax[3];    /* centroid bounds, computed by parent */
} task_t;

/* Scan prim[start:start+cnt] for centroid bounds (root / degenerate). */
static void cent_bounds(ctx_t *c, int32_t start, int32_t cnt,
                        float *cbmin, float *cbmax) {
    cbmin[0] = cbmin[1] = cbmin[2] = FLT_MAX;
    cbmax[0] = cbmax[1] = cbmax[2] = -FLT_MAX;
    for (int32_t i = start; i < start + cnt; i++) {
        const float *ce = c->cent + 3 * c->prim[i];
        for (int a = 0; a < 3; a++) {
            cbmin[a] = fmin3(cbmin[a], ce[a]);
            cbmax[a] = fmax3(cbmax[a], ce[a]);
        }
    }
}

/* Exact AABB of prim[s:e) (degenerate-split path only). */
static void frag_bounds(ctx_t *c, int32_t s, int32_t e,
                        float *cm, float *cx) {
    cm[0] = cm[1] = cm[2] = FLT_MAX;
    cx[0] = cx[1] = cx[2] = -FLT_MAX;
    for (int32_t i = s; i < e; i++) {
        const float *fm = c->fmin + 3 * c->prim[i];
        const float *fx = c->fmax + 3 * c->prim[i];
        for (int k = 0; k < 3; k++) {
            cm[k] = fmin3(cm[k], fm[k]);
            cx[k] = fmax3(cx[k], fx[k]);
        }
    }
}

/* Build the subtree rooted at `node` over prim[start:start+cnt].
 * Iterative with an explicit task stack (≙ the reference's task array). */
static void build_range(ctx_t *c, int32_t root, int32_t start0, int32_t cnt0,
                        const float *cb0min, const float *cb0max) {
    task_t stack[128];
    int sp = 0;
    stack[sp].node = root;
    stack[sp].start = start0;
    stack[sp].cnt = cnt0;
    memcpy(stack[sp].cbmin, cb0min, 12);
    memcpy(stack[sp].cbmax, cb0max, 12);
    sp++;

    while (sp > 0) {
        task_t t = stack[--sp];
        int32_t node = t.node, start = t.start, cnt = t.cnt;
        float *nmn = c->node_min + 3 * node;
        float *nmx = c->node_max + 3 * node;
        const float *cbmin = t.cbmin;
        const float *cbmax = t.cbmax;

        int best_axis = -1, best_bin = -1;
        float best_cost = FLT_MAX;
        /* bins: [fmin.xyz | fmax.xyz | pad][axis][bin] packed as one row of
         * 8 floats so min/max updates vectorize (fmax stored NEGATED so the
         * whole row folds with one min — on AVX2, one _mm256_min_ps) */
        float binrow[3][BINS][8] __attribute__((aligned(32)));
        int32_t bin_cnt[3][BINS];
        float scale[3];

        if (cnt > 1) {
            for (int a = 0; a < 3; a++) {
                float ext = cbmax[a] - cbmin[a];
                scale[a] = ext > 1e-20f ? BINS * 0.999999f / ext : 0.0f;
                for (int b = 0; b < BINS; b++) {
                    bin_cnt[a][b] = 0;
                    for (int k = 0; k < 8; k++) binrow[a][b][k] = FLT_MAX;
                }
            }
#ifdef __AVX2__
            for (int32_t i = start; i < start + cnt; i++) {
                int32_t p = c->prim[i];
                const float *ce = c->cent + 3 * p;
                __m256 row = _mm256_load_ps(c->frag8 + 8 * p);
                for (int a = 0; a < 3; a++) {
                    if (scale[a] == 0.0f) continue;
                    int b = (int)((ce[a] - cbmin[a]) * scale[a]);
                    bin_cnt[a][b]++;
                    float *br = binrow[a][b];
                    _mm256_store_ps(
                        br, _mm256_min_ps(_mm256_load_ps(br), row));
                }
            }
#else
            for (int32_t i = start; i < start + cnt; i++) {
                int32_t p = c->prim[i];
                const float *ce = c->cent + 3 * p;
                const float *row = c->frag8 + 8 * p;
                for (int a = 0; a < 3; a++) {
                    if (scale[a] == 0.0f) continue;
                    int b = (int)((ce[a] - cbmin[a]) * scale[a]);
                    bin_cnt[a][b]++;
                    float *br = binrow[a][b];
                    for (int k = 0; k < 8; k++)
                        br[k] = fmin3(br[k], row[k]);
                }
            }
#endif
            /* SAH sweep per axis; remember the best split's child AABBs
             * (binned bounds, ≙ tiny_bvh.h:2380-2405 — no rescan) */
            for (int a = 0; a < 3; a++) {
                if (scale[a] == 0.0f) continue;
                float sweep[BINS][8];       /* right-to-left suffix rows */
                int32_t rcnt[BINS];
                memcpy(sweep[BINS - 1], binrow[a][BINS - 1], 32);
                rcnt[BINS - 1] = bin_cnt[a][BINS - 1];
                for (int b = BINS - 2; b >= 0; b--) {
                    rcnt[b] = rcnt[b + 1] + bin_cnt[a][b];
                    for (int k = 0; k < 8; k++)
                        sweep[b][k] = fmin3(sweep[b + 1][k], binrow[a][b][k]);
                }
                float lrow[8];
                int32_t lcnt = 0;
                for (int k = 0; k < 8; k++) lrow[k] = FLT_MAX;
                for (int b = 0; b < BINS - 1; b++) {
                    lcnt += bin_cnt[a][b];
                    for (int k = 0; k < 8; k++)
                        lrow[k] = fmin3(lrow[k], binrow[a][b][k]);
                    if (lcnt == 0 || rcnt[b + 1] == 0) continue;
                    float lmx[3] = {-lrow[3], -lrow[4], -lrow[5]};
                    float rmx[3] = {-sweep[b+1][3], -sweep[b+1][4],
                                    -sweep[b+1][5]};
                    float cost = half_area(lrow, lmx) * lcnt
                               + half_area(sweep[b + 1], rmx) * rcnt[b + 1];
                    if (cost < best_cost) {
                        best_cost = cost;
                        best_axis = a;
                        best_bin = b;
                    }
                }
            }
        }

        int make_leaf = 1;
        if (best_axis >= 0) {
            float r_sav = 1.0f / (half_area(nmn, nmx) + 1e-30f);
            float split_cost = C_TRAV + C_INT * r_sav * best_cost;
            float no_split = C_INT * (float)cnt;
            make_leaf = (cnt <= 1) || (split_cost >= no_split);
            if (make_leaf && c->max_leaf > 0 && cnt > c->max_leaf)
                make_leaf = 0;
        } else if (c->max_leaf > 0 && cnt > c->max_leaf) {
            make_leaf = 0; /* forced median split below */
        }

        if (make_leaf || sp >= 126) {
            c->left_first[node] = start;
            c->count[node] = cnt;
            continue;
        }

        int32_t l = c->n_used;
        c->n_used += 2;
        c->left_first[node] = l;
        c->count[node] = 0;
        float *lm = c->node_min + 3 * l, *lx = c->node_max + 3 * l;
        float *rm = lm + 3, *rx = lx + 3;
        task_t *lt = &stack[sp], *rt = &stack[sp + 1];

        int32_t mid;
        if (best_axis >= 0) {
            /* child AABBs from the accumulated bin bounds */
            float row[8];
            for (int k = 0; k < 8; k++) row[k] = FLT_MAX;
            for (int b = 0; b <= best_bin; b++)
                for (int k = 0; k < 8; k++)
                    row[k] = fmin3(row[k], binrow[best_axis][b][k]);
            lm[0]=row[0]; lm[1]=row[1]; lm[2]=row[2];
            lx[0]=-row[3]; lx[1]=-row[4]; lx[2]=-row[5];
            for (int k = 0; k < 8; k++) row[k] = FLT_MAX;
            for (int b = best_bin + 1; b < BINS; b++)
                for (int k = 0; k < 8; k++)
                    row[k] = fmin3(row[k], binrow[best_axis][b][k]);
            rm[0]=row[0]; rm[1]=row[1]; rm[2]=row[2];
            rx[0]=-row[3]; rx[1]=-row[4]; rx[2]=-row[5];

            /* partition + child CENTROID bounds folded into the same pass */
            float lcb[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
            float lcx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
            float rcb[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
            float rcx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
            float cb = cbmin[best_axis], sc = scale[best_axis];
            int32_t i = start, j = start + cnt - 1;
            while (i <= j) {
                const float *ce = c->cent + 3 * c->prim[i];
                int b = (int)((ce[best_axis] - cb) * sc);
                if (b <= best_bin) {
                    for (int k = 0; k < 3; k++) {
                        lcb[k] = fmin3(lcb[k], ce[k]);
                        lcx[k] = fmax3(lcx[k], ce[k]);
                    }
                    i++;
                } else {
                    for (int k = 0; k < 3; k++) {
                        rcb[k] = fmin3(rcb[k], ce[k]);
                        rcx[k] = fmax3(rcx[k], ce[k]);
                    }
                    int32_t tmp = c->prim[i];
                    c->prim[i] = c->prim[j];
                    c->prim[j] = tmp;
                    j--;
                }
            }
            mid = i;
            if (mid == start || mid == start + cnt) {
                mid = start + cnt / 2;   /* numeric fallback: rescan below */
                goto degenerate;
            }
            memcpy(lt->cbmin, lcb, 12); memcpy(lt->cbmax, lcx, 12);
            memcpy(rt->cbmin, rcb, 12); memcpy(rt->cbmax, rcx, 12);
        } else {
            mid = start + cnt / 2; /* degenerate: halve */
        degenerate:
            frag_bounds(c, start, mid, lm, lx);
            frag_bounds(c, mid, start + cnt, rm, rx);
            cent_bounds(c, start, mid - start, lt->cbmin, lt->cbmax);
            cent_bounds(c, mid, start + cnt - mid, rt->cbmin, rt->cbmax);
        }

        lt->node = l; lt->start = start; lt->cnt = mid - start;
        rt->node = l + 1; rt->start = mid; rt->cnt = start + cnt - mid;
        sp += 2;
    }
}

/* Entry point. tris: (n, 9) floats. Outputs sized by caller:
 * node_min/node_max (2n+2, 3), left_first/count (2n+2), prim_idx (n),
 * scratch fmin/fmax/cent (n, 3). Returns used node count. */
int32_t tinybvh_build_binned(
    const float *tris, int32_t n, int32_t max_leaf,
    float *node_min, float *node_max,
    int32_t *left_first, int32_t *count, int32_t *prim_idx,
    float *fmin, float *fmax, float *cent)
{
    float rcb[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float rcx[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    float *rm = node_min, *rx = node_max;
    rm[0] = rm[1] = rm[2] = FLT_MAX;
    rx[0] = rx[1] = rx[2] = -FLT_MAX;
    float *frag8 = (float *)aligned_alloc(32, (size_t)n * 32);
    if (!frag8) return -1;
    for (int32_t i = 0; i < n; i++) {
        const float *t = tris + 9 * i;
        for (int k = 0; k < 3; k++) {
            float mn = fmin3(t[k], fmin3(t[3 + k], t[6 + k]));
            float mx = fmax3(t[k], fmax3(t[3 + k], t[6 + k]));
            float ce = 0.5f * (mn + mx);
            fmin[3 * i + k] = mn;
            fmax[3 * i + k] = mx;
            cent[3 * i + k] = ce;
            frag8[8 * i + k] = mn;
            frag8[8 * i + 3 + k] = -mx;
            rm[k] = fmin3(rm[k], mn);
            rx[k] = fmax3(rx[k], mx);
            rcb[k] = fmin3(rcb[k], ce);
            rcx[k] = fmax3(rcx[k], ce);
        }
        frag8[8 * i + 6] = frag8[8 * i + 7] = 0.0f;
        prim_idx[i] = i;
    }

    ctx_t c = {fmin, fmax, cent, frag8, node_min, node_max,
               left_first, count, prim_idx, 2, max_leaf};
    build_range(&c, 0, 0, n, rcb, rcx);
    free(frag8);
    return c.n_used;
}

/* ------------------------------------------------------------------ */
/* 8-wide collapse with on-the-fly leaf combining.
 *
 * ≙ BVH::CombineLeafs(4) + MBVH<8>::ConvertFrom + BVH8_CPU leaf packing
 * (tiny_bvh.h:3099-3139, 4975-5048, 5692-5761), fused into one native
 * pass: walking the BVH2 is serial-recursive and latency-bound (the
 * numpy/python collapse measured 15 s on a 1.1M-tri scene), so like the
 * builders it runs in C. Emits the SoA wide layout of layouts/mbvh.py:
 * bounds rows [minx*8|miny*8|minz*8|maxx*8|maxy*8|maxz*8], child words
 * (>=0 node row, <0 leaf row -(c+1), EMPTY_SLOT unused), and packed
 * (L,4,3,3) leaf triangles padded with zeros.
 *
 * combine > 0: any subtree whose primitives form a CONTIGUOUS prim_idx
 * range of <= combine prims becomes one leaf (binned SAH splits to ~2
 * tris/leaf at max_leaf=4; packing 4-tri leaves halves the leaf count,
 * the packet G-table size and the dense-MT padding waste). Contiguity
 * is verified per subtree (end-start == total), so optimizer-shuffled
 * trees degrade safely to plain collapse.                               */

#define EMPTY_SLOT (-2147483647)   /* == layouts.mbvh.EMPTY_SLOT */

typedef struct { int32_t b2node, row; } citem_t;

int32_t tinybvh_collapse_bvh8(
    const float *node_min, const float *node_max,     /* (M,3) */
    const int32_t *left_first, const int32_t *cnt, int32_t n_nodes,
    const int32_t *prim_idx, const float *tris,       /* (N,9) */
    int32_t width, int32_t leaf_width, int32_t combine,
    float *bounds,       /* (capN,48) out */
    int32_t *child,      /* (capN,8) out */
    float *leaf_tris,    /* (capL,36) out */
    int32_t *leaf_prim,  /* (capL,4) out */
    int32_t *n_leaves_out)
{
    if (width < 2 || width > 8 || leaf_width != 4) return -1;
    /* ADD_LEAF packs at most leaf_width prims; a larger combine would
     * silently drop triangles from combined leaves. Refuse -> caller
     * falls back to the python collapse, which handles any width. */
    if (combine > leaf_width) return -1;
    /* subtree prim totals + range [start, end): children always have
     * higher indices than their parent in the builders' layouts, so one
     * reverse sweep suffices; bail out (-1 -> caller falls back) if the
     * ordering is violated (e.g. an externally re-linked tree). */
    int64_t *total = (int64_t *)malloc((size_t)n_nodes * 8);
    int32_t *stt = (int32_t *)malloc((size_t)n_nodes * 4);
    int32_t *end = (int32_t *)malloc((size_t)n_nodes * 4);
    citem_t *work = (citem_t *)malloc((size_t)n_nodes * sizeof(citem_t));
    if (!total || !stt || !end || !work) {
        free(total); free(stt); free(end); free(work);
        return -1;
    }
    for (int32_t i = n_nodes - 1; i >= 0; i--) {
        if (i == 1) { total[i] = 0; stt[i] = 0; end[i] = 0; continue; }
        if (cnt[i] > 0) {
            total[i] = cnt[i];
            stt[i] = left_first[i];
            end[i] = left_first[i] + cnt[i];
        } else {
            int32_t l = left_first[i];
            if (l <= i || l + 1 >= n_nodes) {   /* ordering violated */
                free(total); free(stt); free(end); free(work);
                return -1;
            }
            total[i] = total[l] + total[l + 1];
            stt[i] = stt[l] < stt[l + 1] ? stt[l] : stt[l + 1];
            end[i] = end[l] > end[l + 1] ? end[l] : end[l + 1];
        }
    }

    int32_t n_out = 0, n_leaf = 0;

    /* effective leaf: a real BVH2 leaf, or (combine) a small contiguous
     * subtree */
#define IS_LEAF(c) (cnt[c] > 0 || (combine > 0 && total[c] <= combine \
                    && (int64_t)(end[c] - stt[c]) == total[c]))

#define ADD_LEAF(c, dst) do {                                        \
        int32_t first_, cnt_;                                        \
        if (cnt[c] > 0) { first_ = left_first[c]; cnt_ = cnt[c]; }   \
        else { first_ = stt[c]; cnt_ = (int32_t)total[c]; }          \
        int32_t li_ = n_leaf++;                                      \
        int32_t *lp_ = leaf_prim + 4 * li_;                          \
        float *lt_ = leaf_tris + 36 * li_;                           \
        for (int k_ = 0; k_ < 4; k_++) {                             \
            if (k_ < cnt_) {                                         \
                int32_t p_ = prim_idx[first_ + k_];                  \
                lp_[k_] = p_;                                        \
                memcpy(lt_ + 9 * k_, tris + 9 * p_, 36);             \
            } else {                                                 \
                lp_[k_] = -1;                                        \
                memset(lt_ + 9 * k_, 0, 36);                         \
            }                                                        \
        }                                                            \
        (dst) = -(li_ + 1);                                          \
    } while (0)

    if (IS_LEAF(0)) {
        /* root is (or combines to) a leaf: one node, one leaf child */
        float *rb = bounds;
        int32_t *rc = child;
        for (int k = 0; k < 24; k++) rb[k] = 1e30f;   /* BVH_FAR */
        for (int k = 24; k < 48; k++) rb[k] = -1e30f;
        for (int k = 0; k < 8; k++) rc[k] = EMPTY_SLOT;
        for (int k = 0; k < 3; k++) {
            rb[8 * k] = node_min[k];
            rb[24 + 8 * k] = node_max[k];
        }
        ADD_LEAF(0, rc[0]);
        n_out = 1;
    } else {
        int32_t sp = 0;
        work[sp].b2node = 0;
        work[sp].row = n_out++;
        sp++;
        while (sp > 0) {
            citem_t it = work[--sp];
            int32_t kids[8];
            int nk = 2;
            kids[0] = left_first[it.b2node];
            kids[1] = left_first[it.b2node] + 1;
            /* grow: replace the largest-area interior child by its
             * children (≙ tiny_bvh.h:4997-5009) */
            while (nk < width) {
                int best = -1;
                float best_a = -1.0f;
                for (int k = 0; k < nk; k++) {
                    int32_t c = kids[k];
                    if (IS_LEAF(c)) continue;
                    float a = half_area(node_min + 3 * c, node_max + 3 * c);
                    if (a > best_a) { best_a = a; best = k; }
                }
                if (best < 0) break;
                int32_t c = kids[best];
                /* shift-left removal keeps slot order identical to the
                 * python twin (layouts/mbvh.py: kids.pop + extend) */
                for (int k = best; k < nk - 1; k++) kids[k] = kids[k + 1];
                nk--;
                kids[nk++] = left_first[c];
                kids[nk++] = left_first[c] + 1;
            }
            float *rb = bounds + 48 * it.row;
            int32_t *rc = child + 8 * it.row;
            for (int k = 0; k < 24; k++) rb[k] = 1e30f;   /* BVH_FAR */
            for (int k = 24; k < 48; k++) rb[k] = -1e30f;
            for (int k = 0; k < 8; k++) rc[k] = EMPTY_SLOT;
            for (int k = 0; k < nk; k++) {
                int32_t c = kids[k];
                for (int a = 0; a < 3; a++) {
                    rb[8 * a + k] = node_min[3 * c + a];
                    rb[24 + 8 * a + k] = node_max[3 * c + a];
                }
                if (IS_LEAF(c)) {
                    ADD_LEAF(c, rc[k]);
                } else {
                    int32_t row = n_out++;
                    rc[k] = row;
                    work[sp].b2node = c;
                    work[sp].row = row;
                    sp++;
                }
            }
        }
    }
#undef ADD_LEAF
#undef IS_LEAF
    free(total); free(stt); free(end); free(work);
    *n_leaves_out = n_leaf;
    return n_out;
}
