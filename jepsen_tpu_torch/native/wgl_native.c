/* Native WGL linearizability search.
 *
 * The reference's compute kernel is knossos (JVM) — this is the
 * native-runtime equivalent for the host side: a Wing & Gong / Lowe
 * breadth-first search over (prefix, window-bitset, open-set,
 * model-state) configurations, sharing the device kernel's
 * representation (jepsen_tpu/ops/wgl.py docstring): determinate ops
 * sorted by invocation, a prefix pointer p with a 64-bit window bitset,
 * a multi-word open-op set (64 * NO_WORDS ops), and a fixed-width int state vector. Model
 * transition functions mirror jepsen_tpu/models/{register,mutex}.py
 * step_scalar exactly; differential tests pin all three implementations
 * (python host / XLA device / native C) together.
 *
 * Compiled on demand by jepsen_tpu_torch/native/__init__.py with cc (the
 * port's copy of jepsen_tpu/native/wgl_native.c); the ABI
 * is a single entry point:
 *
 *   int wgl_check(args...) -> 1 accepted | 0 not linearizable |
 *                             -1 budget exhausted | -2 unsupported |
 *                             -3 out of memory
 */

#include <pthread.h>
#include <stdatomic.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define S_MAX 8
#define OPEN_SENTINEL 2147483647
#define UNKNOWN_VAL (-2147483647 - 1)

#define NO_WORDS 4 /* open-op set: up to 256 :info ops */

typedef struct {
    int32_t p;
    uint64_t win;
    uint64_t open[NO_WORDS];
    int32_t st[S_MAX];
} cfg_t;

static inline int open_test(const cfg_t *c, int o) {
    return (int)((c->open[o >> 6] >> (o & 63)) & 1);
}

static inline void open_set_bit(cfg_t *c, int o) {
    c->open[o >> 6] |= 1ULL << (o & 63);
}

/* a's open-set is a subset of b's */
static inline int open_subset(const uint64_t *a, const uint64_t *b) {
    for (int w = 0; w < NO_WORDS; w++)
        if (a[w] & ~b[w])
            return 0;
    return 1;
}

static inline int open_eq(const uint64_t *a, const uint64_t *b) {
    for (int w = 0; w < NO_WORDS; w++)
        if (a[w] != b[w])
            return 0;
    return 1;
}

static inline int open_lt(const uint64_t *a, const uint64_t *b) {
    for (int w = NO_WORDS - 1; w >= 0; w--) {
        if (a[w] != b[w])
            return a[w] < b[w];
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Models (mirror models/register.py + models/mutex.py step_scalar).   */

enum {
    MODEL_CAS_REGISTER = 1,   /* also plain register */
    MODEL_MUTEX = 2,
    MODEL_OWNER_MUTEX = 3,
    MODEL_REENTRANT_MUTEX = 4,
    MODEL_FENCED_MUTEX = 5,
    MODEL_REENTRANT_FENCED = 6,
    MODEL_SEMAPHORE = 7
};

/* opcode constants shared with the python encoders */
#define OP_READ 0
#define OP_WRITE 1
#define OP_CAS 2
#define OP_ACQUIRE 0
#define OP_RELEASE 1

int wgl_max_open(void) { return 64 * NO_WORDS; }

static int step_model(int model_id, int64_t param, const int32_t *st,
                      int32_t op, int32_t a1, int32_t a2, int32_t *out) {
    switch (model_id) {
    case MODEL_CAS_REGISTER: {
        int32_t v = st[0];
        if (op == OP_READ) {
            out[0] = v;
            return a1 == UNKNOWN_VAL || v == a1;
        }
        if (op == OP_WRITE) {
            out[0] = a1;
            return 1;
        }
        /* cas */
        if (v == a1) {
            out[0] = a2;
            return 1;
        }
        out[0] = v;
        return 0;
    }
    case MODEL_MUTEX: {
        int32_t locked = st[0];
        if (op == OP_ACQUIRE) {
            out[0] = 1;
            return locked == 0;
        }
        out[0] = 0;
        return locked == 1;
    }
    case MODEL_OWNER_MUTEX: {
        int32_t owner = st[0];
        if (op == OP_ACQUIRE) {
            out[0] = a1 + 1;
            return owner == 0;
        }
        out[0] = 0;
        return owner == a1 + 1;
    }
    case MODEL_REENTRANT_MUTEX: {
        int32_t depth = st[0];
        if (op == OP_ACQUIRE) {
            out[0] = depth + 1;
            return depth < (int32_t)param;
        }
        out[0] = depth > 0 ? depth - 1 : 0;
        return depth > 0;
    }
    case MODEL_FENCED_MUTEX: {
        int32_t owner = st[0], last = st[1];
        if (op == OP_ACQUIRE) {
            out[0] = a1 + 1;
            out[1] = (a2 == UNKNOWN_VAL) ? last : a2;
            return owner == 0 && (a2 == UNKNOWN_VAL || a2 > last);
        }
        out[0] = 0;
        out[1] = last;
        return owner == a1 + 1;
    }
    case MODEL_REENTRANT_FENCED: {
        /* state: owner+1, count, current fence, highest observed */
        int32_t owner = st[0], count = st[1], cur = st[2], hof = st[3];
        int32_t client = a1 + 1, f = a2;
        if (op == OP_ACQUIRE) {
            if (owner == 0) {
                out[0] = client;
                out[1] = 1;
                out[2] = f;
                out[3] = (f != UNKNOWN_VAL && f > hof) ? f : hof;
                return f == UNKNOWN_VAL || f > hof;
            }
            if (owner != client || count >= 2) {
                memcpy(out, st, sizeof(int32_t) * 4);
                return 0;
            }
            if (cur == UNKNOWN_VAL) {
                out[0] = client;
                out[1] = count + 1;
                out[2] = f;
                out[3] = (f != UNKNOWN_VAL && f > hof) ? f : hof;
                return f == UNKNOWN_VAL || f > hof;
            }
            if (f == UNKNOWN_VAL || f == cur) {
                out[0] = client;
                out[1] = count + 1;
                out[2] = cur;
                out[3] = hof;
                return 1;
            }
            memcpy(out, st, sizeof(int32_t) * 4);
            return 0;
        }
        /* release */
        if (owner == 0 || owner != client) {
            memcpy(out, st, sizeof(int32_t) * 4);
            return 0;
        }
        if (count == 1) {
            out[0] = 0;
            out[1] = 0;
            out[2] = UNKNOWN_VAL;
            out[3] = hof;
            return 1;
        }
        out[0] = owner;
        out[1] = count - 1;
        out[2] = cur;
        out[3] = hof;
        return 1;
    }
    case MODEL_SEMAPHORE: {
        int32_t acq = st[0];
        if (op == OP_ACQUIRE) {
            out[0] = acq + a1;
            return acq + a1 <= (int32_t)param;
        }
        out[0] = acq >= a1 ? acq - a1 : 0;
        return acq >= a1;
    }
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Config hash set: open addressing, linear probing.                  */

typedef struct {
    cfg_t *slots;
    uint8_t *used;
    size_t cap; /* power of two */
    size_t count;
} set_t;

static uint64_t cfg_hash(const cfg_t *c, int S) {
    uint64_t h = 1469598103934665603ULL;
    const uint8_t *b = (const uint8_t *)c;
    size_t len = sizeof(int32_t) + sizeof(uint64_t) * 2 +
                 sizeof(int32_t) * (size_t)S;
    /* hash p, win, open, st[0..S) — the struct layout places them first */
    (void)len;
    h = (h ^ (uint64_t)(uint32_t)c->p) * 1099511628211ULL;
    h = (h ^ c->win) * 1099511628211ULL;
    for (int w = 0; w < NO_WORDS; w++)
        h = (h ^ c->open[w]) * 1099511628211ULL;
    for (int i = 0; i < S; i++)
        h = (h ^ (uint64_t)(uint32_t)c->st[i]) * 1099511628211ULL;
    (void)b;
    return h;
}

static int cfg_eq(const cfg_t *a, const cfg_t *b, int S) {
    if (a->p != b->p || a->win != b->win || !open_eq(a->open, b->open))
        return 0;
    return memcmp(a->st, b->st, sizeof(int32_t) * (size_t)S) == 0;
}

static int set_init(set_t *s, size_t cap) {
    s->cap = cap;
    s->count = 0;
    s->slots = (cfg_t *)malloc(sizeof(cfg_t) * cap);
    s->used = (uint8_t *)calloc(cap, 1);
    return s->slots && s->used;
}

static void set_free(set_t *s) {
    free(s->slots);
    free(s->used);
}

static int set_grow(set_t *s, int S);

/* returns 1 if inserted (new), 0 if already present, -1 on OOM */
static int set_insert(set_t *s, const cfg_t *c, int S) {
    if (s->count * 4 >= s->cap * 3) {
        if (!set_grow(s, S))
            return -1;
    }
    uint64_t h = cfg_hash(c, S);
    size_t i = (size_t)(h & (s->cap - 1));
    while (s->used[i]) {
        if (cfg_eq(&s->slots[i], c, S))
            return 0;
        i = (i + 1) & (s->cap - 1);
    }
    s->used[i] = 1;
    s->slots[i] = *c;
    s->count++;
    return 1;
}

static int set_grow(set_t *s, int S) {
    set_t bigger;
    if (!set_init(&bigger, s->cap * 2))
        return 0;
    for (size_t i = 0; i < s->cap; i++) {
        if (!s->used[i]) continue;
        uint64_t h = cfg_hash(&s->slots[i], S);
        size_t j = (size_t)(h & (bigger.cap - 1));
        while (bigger.used[j])
            j = (j + 1) & (bigger.cap - 1);
        bigger.used[j] = 1;
        bigger.slots[j] = s->slots[i];
        bigger.count++;
    }
    set_free(s);
    *s = bigger;
    return 1;
}

/* ------------------------------------------------------------------ */
/* Open-set dominance prune (mirrors the device kernel's): among
 * configs with equal (p, win, state), one whose open-set is a superset
 * of another's is subsumed — open ops are never required, so fewer
 * consumed opens dominates. Sort groups together, then drop entries
 * whose open-set contains the group minimum (or their predecessor). */

static int cfg_cmp(const void *pa, const void *pb) {
    /* No per-call state: lanes beyond the model's S are always zero
     * (the root config is memset and transitions write only S lanes),
     * so comparing the full S_MAX width is equivalent — and keeps the
     * comparator safe under concurrent checks. */
    const cfg_t *a = (const cfg_t *)pa, *b = (const cfg_t *)pb;
    if (a->p != b->p)
        return a->p < b->p ? -1 : 1;
    if (a->win != b->win)
        return a->win < b->win ? -1 : 1;
    int c = memcmp(a->st, b->st, sizeof(int32_t) * S_MAX);
    if (c)
        return c;
    if (!open_eq(a->open, b->open))
        return open_lt(a->open, b->open) ? -1 : 1;
    return 0;
}

static size_t dominance_prune(cfg_t *items, size_t len, int S) {
    if (len < 2)
        return len;
    qsort(items, len, sizeof(cfg_t), cfg_cmp);
    size_t out = 0;
    uint64_t head_open[NO_WORDS] = {0};
    const cfg_t *group = NULL;
    uint64_t prev_open[NO_WORDS] = {0};
    for (size_t i = 0; i < len; i++) {
        cfg_t *c = &items[i];
        int same = group && c->p == group->p && c->win == group->win &&
                   memcmp(c->st, group->st,
                          sizeof(int32_t) * (size_t)S) == 0;
        if (!same) {
            group = c;
            memcpy(head_open, c->open, sizeof(head_open));
            memcpy(prev_open, c->open, sizeof(prev_open));
            items[out++] = *c;
            continue;
        }
        /* drop exact dups, supersets of the group head, and supersets
         * of the previous (kept-or-dropped) entry — sound by induction */
        if (open_subset(head_open, c->open) ||
            open_subset(prev_open, c->open)) {
            memcpy(prev_open, c->open, sizeof(prev_open));
            continue;
        }
        memcpy(prev_open, c->open, sizeof(prev_open));
        items[out++] = *c;
    }
    return out;
}

/* ------------------------------------------------------------------ */
/* Dominance-aware memo for the DFS: a hash map keyed by
 * (p, win, state) whose value is an ANTICHAIN of open-masks, kept
 * sorted by popcount. A new config whose open-set is a superset of any
 * stored mask for its key is subsumed (open ops are never required and
 * never bound others: every future reachable from the superset is
 * reachable from the subset with identical state) — this collapses the
 * open-subset powerset that dominates refutation cost, where the
 * exact-equality memo had to visit every subset combination.
 * Stored masks that are supersets of a new mask are removed: the new
 * (dominating) entry prunes everything they would have pruned. */

/* Dominance-memo mask width: one word for the window-read complement
 * (the read-collapse reduction) plus the open-op set.  For register
 * models, a linearized READ never changes state, so config A dominates
 * B at the same (p, non-read window bits, state) whenever A has
 * linearized a SUPERSET of the window reads with a SUBSET of the open
 * ops: delete the extra reads from B's accepting completion and the
 * state trajectory is unchanged while every min-return bound only
 * loosens.  Encoding the read bits as their complement turns both
 * conditions into one componentwise subset test over [read-compl,
 * open words] — exactly the antichain machinery below. */
#define DOM_WORDS (NO_WORDS + 1)

typedef struct {
    int32_t p;
    uint64_t win;
    int32_t st[S_MAX];
    int32_t n;        /* stored masks */
    int32_t mcap;
    uint64_t *masks;  /* n * DOM_WORDS, popcount-ascending */
    uint8_t *pc;      /* popcount per mask */
} dom_slot_t;

typedef struct {
    dom_slot_t *slots;
    uint8_t *used;
    size_t cap;   /* power of two */
    size_t count; /* distinct keys */
} domset_t;

static uint64_t dom_key_hash(int32_t p, uint64_t win, const int32_t *st) {
    /* Always hashes S_MAX state lanes: lanes beyond the model's S are
     * zero everywhere (the root is memset and transitions write only S
     * lanes), so this is S-independent — the table can rehash without
     * knowing S. */
    uint64_t h = 1469598103934665603ULL;
    h = (h ^ (uint64_t)(uint32_t)p) * 1099511628211ULL;
    h = (h ^ win) * 1099511628211ULL;
    for (int i = 0; i < S_MAX; i++)
        h = (h ^ (uint64_t)(uint32_t)st[i]) * 1099511628211ULL;
    return h;
}

static int dom_init(domset_t *s, size_t cap) {
    s->cap = cap;
    s->count = 0;
    s->slots = (dom_slot_t *)malloc(sizeof(dom_slot_t) * cap);
    s->used = (uint8_t *)calloc(cap, 1);
    return s->slots && s->used;
}

static void dom_free(domset_t *s) {
    if (s->slots)
        for (size_t i = 0; i < s->cap; i++)
            if (s->used[i])
                free(s->slots[i].masks); /* pc rides the same block */
    free(s->slots);
    free(s->used);
}

static int dom_popcount(const uint64_t *m) {
    int n = 0;
    for (int w = 0; w < DOM_WORDS; w++)
        n += __builtin_popcountll(m[w]);
    /* Clamped to fit the uint8_t pc lanes: 320 set bits (a full
     * 5-word vector) would wrap and skip the whole subset scan. The
     * clamp only coarsens the scan bound — subset checks run on the
     * real masks. */
    return n > 255 ? 255 : n;
}

static inline int dom_subset(const uint64_t *a, const uint64_t *b) {
    for (int w = 0; w < DOM_WORDS; w++)
        if (a[w] & ~b[w])
            return 0;
    return 1;
}

static int dom_slot_grow(dom_slot_t *d) {
    int nc = d->mcap ? d->mcap * 2 : 4;
    /* one allocation: masks block then pc block */
    uint64_t *nm = (uint64_t *)malloc(
        (sizeof(uint64_t) * DOM_WORDS + 1) * (size_t)nc);
    if (!nm)
        return 0;
    uint8_t *npc = (uint8_t *)(nm + (size_t)nc * DOM_WORDS);
    if (d->n) {
        memcpy(nm, d->masks, sizeof(uint64_t) * DOM_WORDS * (size_t)d->n);
        memcpy(npc, d->pc, (size_t)d->n);
    }
    free(d->masks);
    d->masks = nm;
    d->pc = npc;
    d->mcap = nc;
    return 1;
}

static int dom_grow(domset_t *s);

/* Project a config onto the memo coordinates: win_key = window bits
 * with in-window READ bits removed; mvec = [read-complement, open
 * words].  romask[p] has bit j set when det row p+j is state-neutral
 * (a register read); NULL disables the read-collapse (non-register
 * models). */
static inline void dom_project(const cfg_t *c, const uint64_t *romask,
                               int32_t nD, int32_t W,
                               uint64_t *win_key, uint64_t *m) {
    uint64_t ro = 0;
    if (romask && c->p < nD) {
        int32_t wl = nD - c->p;
        if (wl > W)
            wl = W;
        uint64_t lim = (wl >= 64) ? ~0ULL : ((1ULL << wl) - 1);
        ro = romask[c->p] & lim;
    }
    *win_key = c->win & ~ro;
    m[0] = ro & ~c->win;
    for (int w = 0; w < NO_WORDS; w++)
        m[1 + w] = c->open[w];
}

/* 1 = inserted (explore), 0 = dominated (prune), -1 = OOM */
static int dom_insert(domset_t *s, int32_t p, uint64_t win_key,
                      const int32_t *st, const uint64_t *mvec) {
    if (s->count * 4 >= s->cap * 3) {
        if (!dom_grow(s))
            return -1;
    }
    uint64_t h = dom_key_hash(p, win_key, st);
    size_t i = (size_t)(h & (s->cap - 1));
    dom_slot_t *d = NULL;
    while (s->used[i]) {
        d = &s->slots[i];
        if (d->p == p && d->win == win_key &&
            memcmp(d->st, st, sizeof(d->st)) == 0)
            break;
        d = NULL;
        i = (i + 1) & (s->cap - 1);
    }
    int pc_new = dom_popcount(mvec);
    if (d == NULL) {
        /* fresh key */
        s->used[i] = 1;
        d = &s->slots[i];
        d->p = p;
        d->win = win_key;
        memcpy(d->st, st, sizeof(d->st));
        d->n = 0;
        d->mcap = 0;
        d->masks = NULL;
        d->pc = NULL;
        if (!dom_slot_grow(d))
            return -1;
        memcpy(d->masks, mvec, sizeof(uint64_t) * DOM_WORDS);
        d->pc[0] = (uint8_t)pc_new;
        d->n = 1;
        s->count++;
        return 1;
    }
    /* popcount-sorted scan: only masks with pc <= pc_new can be
     * subsets of the new mask */
    int32_t k = 0;
    for (; k < d->n && d->pc[k] <= pc_new; k++)
        if (dom_subset(d->masks + (size_t)k * DOM_WORDS, mvec))
            return 0; /* dominated */
    /* remove stored supersets (they are now redundant pruners) */
    int32_t w = k;
    for (int32_t j = k; j < d->n; j++) {
        if (dom_subset(mvec, d->masks + (size_t)j * DOM_WORDS))
            continue; /* superset of new: drop */
        if (w != j) {
            memcpy(d->masks + (size_t)w * DOM_WORDS,
                   d->masks + (size_t)j * DOM_WORDS,
                   sizeof(uint64_t) * DOM_WORDS);
            d->pc[w] = d->pc[j];
        }
        w++;
    }
    d->n = w;
    if (d->n == d->mcap && !dom_slot_grow(d))
        return -1;
    /* insert at position k (popcount order preserved) */
    memmove(d->masks + (size_t)(k + 1) * DOM_WORDS,
            d->masks + (size_t)k * DOM_WORDS,
            sizeof(uint64_t) * DOM_WORDS * (size_t)(d->n - k));
    memmove(d->pc + k + 1, d->pc + k, (size_t)(d->n - k));
    memcpy(d->masks + (size_t)k * DOM_WORDS, mvec,
           sizeof(uint64_t) * DOM_WORDS);
    d->pc[k] = (uint8_t)pc_new;
    d->n++;
    return 1;
}

static int dom_grow(domset_t *s) {
    domset_t bigger;
    if (!dom_init(&bigger, s->cap * 2))
        return 0;
    for (size_t i = 0; i < s->cap; i++) {
        if (!s->used[i])
            continue;
        dom_slot_t *d = &s->slots[i];
        uint64_t h = dom_key_hash(d->p, d->win, d->st);
        size_t j = (size_t)(h & (bigger.cap - 1));
        while (bigger.used[j])
            j = (j + 1) & (bigger.cap - 1);
        bigger.used[j] = 1;
        bigger.slots[j] = *d; /* masks pointer moves with the slot */
        bigger.count++;
    }
    free(s->slots);
    free(s->used);
    *s = bigger;
    return 1;
}

/* ------------------------------------------------------------------ */
/* The search.                                                         */

typedef struct {
    cfg_t *items;
    size_t len, cap;
} vec_t;

static int vec_push(vec_t *v, const cfg_t *c) {
    if (v->len == v->cap) {
        size_t nc = v->cap ? v->cap * 2 : 1024;
        cfg_t *ni = (cfg_t *)realloc(v->items, sizeof(cfg_t) * nc);
        if (!ni)
            return 0;
        v->items = ni;
        v->cap = nc;
    }
    v->items[v->len++] = *c;
    return 1;
}

/* ------------------------------------------------------------------ */
/* Shared expansion logic: candidate bounds and the per-slot transition
 * filter, used identically by the sequential DFS, the parallel DFS's
 * seeding sweep, and its workers (one copy — the three loops cannot
 * drift). */

/* Twin tables for the interval-containment symmetry reduction.
 *
 * Two ops with the same (op, a1, a2) have identical step behavior, so
 * they are interchangeable wherever both are applicable.  If i's
 * realtime interval is CONTAINED in j's (inv_i >= inv_j and
 * ret_i <= ret_j), any completion that linearizes j "now" and i at a
 * later point t can be rewritten with the two swapped: j at t is legal
 * because inv_j <= inv_i < min_ret_t, and every intermediate filter
 * only LOOSENS (the pending set trades i for j, and ret_i <= ret_j
 * can only raise the min-return bound).  So a search that, at each
 * config, skips candidate j whenever a contained same-class twin i is
 * itself applicable is still complete — it explores the innermost
 * applicable twin first and the rest never need to be branched on.
 * Open (:info) ops have ret = +inf, which makes every later-invoked
 * same-class open a contained twin, and every same-class determinate
 * op invoked after the open one too (det ops prune opens; opens never
 * prune dets).  This collapses the 2^k applied-subset blowup of
 * crashed ops around a refutation's stuck point. */
typedef struct {
    int32_t n_cls;
    int32_t *clsD;      /* [nD] class id per det row */
    int32_t *cposD;     /* [nD] row's position inside its class list */
    int32_t *crows_off; /* [n_cls+1] CSR offsets into crows */
    int32_t *crows;     /* det rows per class, ascending row (== inv) */
    int32_t *clsO;      /* [nO] class id per open op */
    int32_t *cposO;     /* [nO] open's position inside its class list */
    int32_t *copen_off; /* [n_cls+1] CSR offsets into copens */
    int32_t *copens;    /* open idxs per class, ascending idx (== inv) */
    int32_t *odet_start;/* [nO] first index in the open's class crows
                           with invD >= invO[o] */
} twins_t;

typedef struct {
    int32_t nD, nO, S, W;
    const int32_t *invD, *retD, *opD, *a1D, *a2D, *sufret;
    const int32_t *invO, *opO, *a1O, *a2O;
    int32_t model_id;
    int64_t model_param;
    const twins_t *tw; /* NULL = reduction disabled */
} tabs_t;

typedef struct {
    int32_t op, a1, a2, kind, idx; /* kind: 0 det, 1 open */
} tkey_t;

static int tkey_cmp(const void *pa, const void *pb) {
    const tkey_t *a = (const tkey_t *)pa, *b = (const tkey_t *)pb;
    if (a->op != b->op) return a->op < b->op ? -1 : 1;
    if (a->a1 != b->a1) return a->a1 < b->a1 ? -1 : 1;
    if (a->a2 != b->a2) return a->a2 < b->a2 ? -1 : 1;
    if (a->kind != b->kind) return a->kind - b->kind;
    return a->idx < b->idx ? -1 : (a->idx > b->idx);
}

static void twin_free(twins_t *X) {
    if (!X)
        return;
    free(X->clsD);
    free(X->cposD);
    free(X->crows_off);
    free(X->crows);
    free(X->clsO);
    free(X->cposO);
    free(X->copen_off);
    free(X->copens);
    free(X->odet_start);
    free(X);
}

/* Build the class tables; NULL on OOM or when the inv arrays are not
 * ascending (the encoders sort by invocation — verified here so the
 * reduction silently disables rather than mis-pruning if that ever
 * changes). */
static twins_t *twin_build(int32_t nD, int32_t nO,
                           const int32_t *opD, const int32_t *a1D,
                           const int32_t *a2D, const int32_t *invD,
                           const int32_t *opO, const int32_t *a1O,
                           const int32_t *a2O, const int32_t *invO) {
    for (int32_t i = 1; i < nD; i++)
        if (invD[i] < invD[i - 1])
            return NULL;
    for (int32_t i = 1; i < nO; i++)
        if (invO[i] < invO[i - 1])
            return NULL;
    size_t n = (size_t)nD + (size_t)nO;
    tkey_t *keys = (tkey_t *)malloc(sizeof(tkey_t) * (n ? n : 1));
    twins_t *X = (twins_t *)calloc(1, sizeof(twins_t));
    if (!keys || !X) {
        free(keys);
        free(X);
        return NULL;
    }
    for (int32_t i = 0; i < nD; i++)
        keys[i] = (tkey_t){opD[i], a1D[i], a2D[i], 0, i};
    for (int32_t i = 0; i < nO; i++)
        keys[nD + i] = (tkey_t){opO[i], a1O[i], a2O[i], 1, i};
    qsort(keys, n, sizeof(tkey_t), tkey_cmp);
    int32_t n_cls = 0;
    for (size_t i = 0; i < n; i++)
        if (i == 0 || keys[i].op != keys[i - 1].op ||
            keys[i].a1 != keys[i - 1].a1 || keys[i].a2 != keys[i - 1].a2)
            n_cls++;
    X->n_cls = n_cls;
    X->clsD = (int32_t *)malloc(sizeof(int32_t) * (nD ? nD : 1));
    X->cposD = (int32_t *)malloc(sizeof(int32_t) * (nD ? nD : 1));
    X->crows_off = (int32_t *)calloc((size_t)n_cls + 1, sizeof(int32_t));
    X->crows = (int32_t *)malloc(sizeof(int32_t) * (nD ? nD : 1));
    X->clsO = (int32_t *)malloc(sizeof(int32_t) * (nO ? nO : 1));
    X->cposO = (int32_t *)malloc(sizeof(int32_t) * (nO ? nO : 1));
    X->copen_off = (int32_t *)calloc((size_t)n_cls + 1, sizeof(int32_t));
    X->copens = (int32_t *)malloc(sizeof(int32_t) * (nO ? nO : 1));
    X->odet_start = (int32_t *)malloc(sizeof(int32_t) * (nO ? nO : 1));
    if (!X->clsD || !X->cposD || !X->crows_off || !X->crows || !X->clsO ||
        !X->cposO || !X->copen_off || !X->copens || !X->odet_start) {
        free(keys);
        twin_free(X);
        return NULL;
    }
    /* qsort's (op,a1,a2,kind,idx) total order yields ascending idx per
     * (class, kind) run — class member lists stay inv-sorted. */
    int32_t cls = -1, nd = 0, no = 0;
    for (size_t i = 0; i < n; i++) {
        if (i == 0 || keys[i].op != keys[i - 1].op ||
            keys[i].a1 != keys[i - 1].a1 || keys[i].a2 != keys[i - 1].a2)
            cls++;
        if (keys[i].kind == 0) {
            X->clsD[keys[i].idx] = cls;
            X->crows[nd++] = keys[i].idx;
            X->crows_off[cls + 1] = nd;
        } else {
            X->clsO[keys[i].idx] = cls;
            X->copens[no++] = keys[i].idx;
            X->copen_off[cls + 1] = no;
        }
    }
    /* fill gaps: classes with no det (or open) members inherit the
     * previous end so off[c]..off[c+1] is an empty range */
    for (int32_t c2 = 1; c2 <= n_cls; c2++) {
        if (X->crows_off[c2] < X->crows_off[c2 - 1])
            X->crows_off[c2] = X->crows_off[c2 - 1];
        if (X->copen_off[c2] < X->copen_off[c2 - 1])
            X->copen_off[c2] = X->copen_off[c2 - 1];
    }
    for (int32_t c2 = 0; c2 < n_cls; c2++) {
        for (int32_t q = X->crows_off[c2]; q < X->crows_off[c2 + 1]; q++)
            X->cposD[X->crows[q]] = q;
        for (int32_t q = X->copen_off[c2]; q < X->copen_off[c2 + 1]; q++)
            X->cposO[X->copens[q]] = q;
    }
    for (int32_t o = 0; o < nO; o++) {
        int32_t c2 = X->clsO[o];
        int32_t lo = X->crows_off[c2], hi = X->crows_off[c2 + 1];
        while (lo < hi) {
            int32_t mid = (lo + hi) >> 1;
            if (invD[X->crows[mid]] < invO[o])
                lo = mid + 1;
            else
                hi = mid;
        }
        X->odet_start[o] = lo;
    }
    free(keys);
    return X;
}

static inline void cfg_bounds(const tabs_t *T, const cfg_t *c,
                              int32_t *wlim_out, int32_t *min_ret_out,
                              int32_t *n_cand_out) {
    int32_t wlim = (T->nD - c->p < T->W) ? T->nD - c->p : T->W;
    int32_t min_ret =
        T->sufret[(c->p + T->W < T->nD) ? c->p + T->W : T->nD];
    for (int j = 0; j < wlim; j++)
        if (!((c->win >> j) & 1) && T->retD[c->p + j] < min_ret)
            min_ret = T->retD[c->p + j];
    /* invD ascends with row, and inv < ret makes the ret==min_ret
     * escape impossible once invD >= min_ret — so the candidate scan
     * can stop at the first too-late row (typ. 1/3 of the window).
     * Same for the invO-ascending open ops. */
    int32_t we = 0;
    while (we < wlim && T->invD[c->p + we] < min_ret)
        we++;
    int32_t ol = 0;
    while (ol < T->nO && T->invO[ol] < min_ret)
        ol++;
    *wlim_out = we;
    *min_ret_out = min_ret;
    *n_cand_out = we + ol;
}

/* Try candidate slot j (0..wlim-1 window ops, wlim..wlim+nO-1 open
 * ops). 0 = filtered, 1 = successor written to *out, 2 = the history
 * completed (accepting linearization found). */
static inline int cfg_try(const tabs_t *T, const cfg_t *c, int32_t wlim,
                          int32_t min_ret, int32_t j, cfg_t *out) {
    cfg_t c2 = *c;
    const twins_t *X = T->tw;
    if (j < wlim) {
        if ((c->win >> j) & 1)
            return 0;
        int32_t row = c->p + j;
        if (T->invD[row] >= min_ret && T->retD[row] != min_ret)
            return 0;
        if (X) {
            /* twin pruning: a later-invoked same-class det op whose
             * return is no later (contained interval) and which is
             * itself applicable makes this branch redundant */
            int32_t end = X->crows_off[X->clsD[row] + 1];
            for (int32_t q = X->cposD[row] + 1; q < end; q++) {
                int32_t r2 = X->crows[q];
                if (r2 - c->p >= wlim)
                    break; /* rows ascend: the rest are out of window */
                if (T->invD[r2] >= min_ret)
                    break; /* rows ascend in inv: the rest fail too */
                if (((c->win >> (r2 - c->p)) & 1))
                    continue; /* already linearized */
                if (T->retD[r2] <= T->retD[row])
                    return 0; /* contained applicable twin exists */
            }
        }
        if (!step_model(T->model_id, T->model_param, c->st, T->opD[row],
                        T->a1D[row], T->a2D[row], c2.st))
            return 0;
        c2.win = c->win | (1ULL << j);
        while (c2.win & 1) {
            c2.win >>= 1;
            c2.p++;
        }
        if (c2.p >= T->nD)
            return 2;
    } else {
        int o = j - wlim;
        if (open_test(c, o))
            return 0;
        if (T->invO[o] >= min_ret)
            return 0;
        if (T->model_id == MODEL_CAS_REGISTER && T->opO[o] == OP_READ)
            return 0; /* applying a state-neutral open changes nothing:
                         the parent config dominates the successor */
        if (X) {
            int32_t cls = X->clsO[o];
            /* later-invoked same-class opens: contained (ret = inf) */
            int32_t oend = X->copen_off[cls + 1];
            for (int32_t q = X->cposO[o] + 1; q < oend; q++) {
                int32_t o2 = X->copens[q];
                if (T->invO[o2] >= min_ret)
                    break; /* opens ascend in inv */
                if (!open_test(c, o2))
                    return 0;
            }
            /* determinate same-class ops invoked after this open: their
             * finite interval is contained in [invO, inf) */
            int32_t dend = X->crows_off[cls + 1];
            int32_t lo = X->odet_start[o], hi = dend;
            while (lo < hi) { /* first class row still in the window */
                int32_t mid = (lo + hi) >> 1;
                if (X->crows[mid] < c->p)
                    lo = mid + 1;
                else
                    hi = mid;
            }
            for (int32_t q = lo; q < dend; q++) {
                int32_t r2 = X->crows[q];
                if (r2 - c->p >= wlim)
                    break;
                if (T->invD[r2] >= min_ret)
                    break;
                if (!((c->win >> (r2 - c->p)) & 1))
                    return 0; /* applicable det twin exists */
            }
        }
        if (!step_model(T->model_id, T->model_param, c->st, T->opO[o],
                        T->a1O[o], T->a2O[o], c2.st))
            return 0;
        open_set_bit(&c2, o);
    }
    *out = c2;
    return 1;
}

static inline int32_t cfg_depth(const cfg_t *c) {
    int32_t d = c->p;
    uint64_t w = c->win;
    while (w) {
        d += (int32_t)(w & 1);
        w >>= 1;
    }
    return d;
}

/* ------------------------------------------------------------------ */
/* Depth-first search with memoization (Lowe / knossos-"linear" style):
 * follow one linearization, backtracking on dead ends; the memo set
 * guarantees each configuration is expanded at most once, so valid
 * histories are near-linear (real-time candidate order first) and
 * invalid ones terminate after covering the reachable space. */

typedef struct {
    cfg_t cfg;
    int32_t next_j; /* next candidate slot to try: 0..n_cand */
    int32_t min_ret;
    int32_t wlim;
    int32_t n_cand;
    /* eager-read cache: the successor computed by the first-visit scan
     * (avoids running cfg_try twice on the hot read path) */
    cfg_t eager;
    int32_t eager_j; /* -1 = none */
    int32_t eager_r;
} frame_t;

/* Per-row "state-neutral" mask for the read-collapse dominance: bit j
 * of romask[p] is set when det row p+j is a register READ.  NULL for
 * models with no state-neutral ops. */
static uint64_t *romask_build(int32_t nD, int32_t model_id,
                              const int32_t *opD) {
    if (model_id != MODEL_CAS_REGISTER)
        return NULL;
    uint64_t *ro = (uint64_t *)malloc(sizeof(uint64_t) * (nD ? nD : 1));
    if (!ro)
        return NULL;
    uint64_t acc = 0;
    for (int32_t p = nD - 1; p >= 0; p--) {
        acc = (acc << 1) | (uint64_t)(opD[p] == OP_READ);
        ro[p] = acc;
    }
    return ro;
}

/* Witness buffer entry stride, in int32 lanes:
 * [p, win_lo, win_hi, open x 2*NO_WORDS, st x S_MAX] */
int wgl_witness_stride(void) { return 3 + 2 * NO_WORDS + S_MAX; }

static void wit_record(int32_t *buf, int32_t cap, int32_t *len,
                       int32_t *depth_seen, int32_t d, const cfg_t *c) {
    if (!buf || cap <= 0)
        return;
    if (d > *depth_seen) {
        *depth_seen = d;
        *len = 0; /* deeper configs supersede shallower witnesses */
    } else if (d < *depth_seen || *len >= cap) {
        return;
    }
    int32_t *e = buf + (size_t)(*len) * (size_t)wgl_witness_stride();
    e[0] = c->p;
    e[1] = (int32_t)(uint32_t)(c->win & 0xFFFFFFFFULL);
    e[2] = (int32_t)(uint32_t)(c->win >> 32);
    for (int w = 0; w < NO_WORDS; w++) {
        e[3 + 2 * w] = (int32_t)(uint32_t)(c->open[w] & 0xFFFFFFFFULL);
        e[4 + 2 * w] = (int32_t)(uint32_t)(c->open[w] >> 32);
    }
    memcpy(e + 3 + 2 * NO_WORDS, c->st, sizeof(int32_t) * S_MAX);
    (*len)++;
}

int wgl_check_dfs(
    int32_t nD, int32_t nO, int32_t S, int32_t W,
    const int32_t *invD, const int32_t *retD, const int32_t *opD,
    const int32_t *a1D, const int32_t *a2D,
    const int32_t *sufret,
    const int32_t *invO, const int32_t *opO,
    const int32_t *a1O, const int32_t *a2O,
    const int32_t *init_state,
    int32_t model_id, int64_t model_param,
    int64_t max_configs,
    int64_t *configs_explored, int32_t *frontier_max,
    int32_t *max_linearized,
    /* optional deepest-config capture (the refutation witness the
     * reference renders as linear.svg, checker.clj:202-209): up to
     * wit_cap entries of wgl_witness_stride() lanes each; NULL/0 to
     * disable */
    int32_t *wit_buf, int32_t wit_cap, int32_t *wit_len,
    /* optional cooperative cancellation: when *cancel becomes nonzero
     * the search returns -1 (budget semantics) at the next poll — the
     * competition race uses this so a losing DFS stops promptly
     * instead of grinding to its full config budget. NULL = never. */
    const volatile int32_t *cancel) {
    if (W > 64 || nO > 64 * NO_WORDS || S > S_MAX)
        return -2;
    *configs_explored = 0;
    *frontier_max = 0;
    *max_linearized = 0;
    if (wit_len)
        *wit_len = 0;
    if (nD == 0)
        return 1;

    domset_t seen;
    if (!dom_init(&seen, 1 << 16))
        return -3;

    size_t depth_cap = (size_t)nD + (size_t)nO + 2;
    frame_t *stack = (frame_t *)malloc(sizeof(frame_t) * depth_cap);
    if (!stack) {
        dom_free(&seen);
        return -3;
    }
    size_t sp = 0;

    tabs_t T = {nD, nO, S, W, invD, retD, opD, a1D, a2D, sufret,
                invO, opO, a1O, a2O, model_id, model_param, NULL};
    twins_t *X = twin_build(nD, nO, opD, a1D, a2D, invD,
                            opO, a1O, a2O, invO);
    T.tw = X; /* NULL (OOM / unsorted inv) just disables the reduction */
    uint64_t *romask = romask_build(nD, model_id, opD);

    frame_t root;
    memset(&root, 0, sizeof(root));
    memcpy(root.cfg.st, init_state, sizeof(int32_t) * (size_t)S);
    root.next_j = -1; /* compute bounds lazily on first visit */
    stack[sp++] = root;
    {
        uint64_t wk, mv[DOM_WORDS];
        dom_project(&root.cfg, romask, nD, W, &wk, mv);
        dom_insert(&seen, root.cfg.p, wk, root.cfg.st, mv);
    }

    int64_t explored = 0;
    int verdict = 0;

    while (sp) {
        frame_t *fr = &stack[sp - 1];
        cfg_t *c = &fr->cfg;
        if (fr->next_j < 0) {
            /* first visit: compute window limit + min completion */
            explored++;
            if (explored > max_configs ||
                ((explored & 0x3FF) == 0 && cancel && *cancel)) {
                verdict = -1;
                break;
            }
            cfg_bounds(&T, c, &fr->wlim, &fr->min_ret, &fr->n_cand);
            fr->next_j = 0;
            fr->eager_j = -1;
            if (romask && fr->wlim > 0) {
                /* eager-read propagation: an applicable window READ can
                 * be moved to the front of any accepting completion
                 * (state-neutral; dropping it from the pending set only
                 * loosens min-return bounds), so this config has
                 * exactly ONE successor worth branching on. */
                for (int32_t j = 0; j < fr->wlim; j++) {
                    if (!((romask[c->p] >> j) & 1))
                        continue;
                    int r = cfg_try(&T, c, fr->wlim, fr->min_ret, j,
                                    &fr->eager);
                    if (r) {
                        fr->next_j = j;
                        fr->n_cand = j + 1;
                        fr->eager_j = j;
                        fr->eager_r = r;
                        break;
                    }
                }
            }
            {
                int32_t d = cfg_depth(c);
                wit_record(wit_buf, wit_cap, wit_len, max_linearized, d, c);
                if (d > *max_linearized)
                    *max_linearized = d;
            }
        }
        int advanced = 0;
        while (fr->next_j < fr->n_cand) {
            int j = fr->next_j++;
            cfg_t c2;
            int r;
            if (j == fr->eager_j) {
                c2 = fr->eager;
                r = fr->eager_r;
            } else {
                r = cfg_try(&T, c, fr->wlim, fr->min_ret, j, &c2);
            }
            if (r == 0)
                continue;
            if (r == 2) {
                verdict = 1;
                break;
            }
            uint64_t wk, mv[DOM_WORDS];
            dom_project(&c2, romask, nD, W, &wk, mv);
            int ins = dom_insert(&seen, c2.p, wk, c2.st, mv);
            if (ins < 0) {
                verdict = -3;
                break;
            }
            if (!ins)
                continue; /* dominated: an explored config with equal
                             (p, win, state) and open-subset covers
                             every future of this one */
            frame_t nf;
            nf.cfg = c2;
            nf.next_j = -1;
            nf.min_ret = 0;
            nf.wlim = 0;
            stack[sp++] = nf;
            advanced = 1;
            break;
        }
        if (verdict)
            break;
        if (!advanced)
            sp--; /* dead end: backtrack */
        if ((int32_t)sp > *frontier_max)
            *frontier_max = (int32_t)sp; /* stack depth as diagnostic */
    }

    *configs_explored = explored;
    free(stack);
    dom_free(&seen);
    twin_free(X);
    free(romask);
    return verdict;
}

/* ------------------------------------------------------------------ */
/* Parallel DFS: the same memoized search fanned over worker threads.
 *
 * Discovered-but-unexpanded configs live on ONE shared LIFO stack;
 * workers pop small batches off the top, expand them, and push
 * successors back in reverse candidate order (so the stack top is the
 * real-time-first candidate — the ordering that makes valid histories
 * near-linear in the sequential DFS). The dominance memo is ONE
 * logical set striped into PAR_STRIPES independently-growing hash
 * tables, each under its own mutex — a worker that finds a config
 * dominated can rely on whichever worker inserted the dominating
 * config to (have) explore(d) its whole subtree, exactly the
 * sequential argument. Refutation (verdict 0) is only claimed when the
 * stack empties with zero configs mid-expansion and no budget trip or
 * cancellation, so concurrent pruning can never manufacture a false
 * "invalid". Valid verdicts short-circuit all workers. */

#define PAR_STRIPES 128
#define PAR_POP_BATCH 16
/* successors of one config: <= W window + nO open candidates */
#define PAR_MAX_SUCC (64 + 64 * NO_WORDS)

typedef struct {
    tabs_t T;
    const uint64_t *romask; /* read-collapse mask, NULL for lock models */
    int64_t max_configs;
    const volatile int32_t *cancel;
    domset_t sets[PAR_STRIPES];
    pthread_mutex_t mus[PAR_STRIPES];
    /* shared work stack + in-flight accounting */
    pthread_mutex_t qmu;
    vec_t q;
    size_t q_peak;
    atomic_llong pending; /* configs on the stack or mid-expansion */
    atomic_llong explored;
    atomic_int decided; /* 0 running | 1 valid | -1 budget/cancel | -3 oom */
    /* deepest-config witness capture (shared; mutex-guarded) */
    pthread_mutex_t wit_mu;
    int32_t *wit_buf;
    int32_t wit_cap;
    int32_t *wit_len;
    int32_t maxlin_plain;
    atomic_int maxlin;
} par_t;

static int par_insert(par_t *P, const cfg_t *c) {
    uint64_t wk, mv[DOM_WORDS];
    dom_project(c, P->romask, P->T.nD, P->T.W, &wk, mv);
    uint64_t h = dom_key_hash(c->p, wk, c->st);
    int s = (int)(h >> 56) & (PAR_STRIPES - 1);
    pthread_mutex_lock(&P->mus[s]);
    int r = dom_insert(&P->sets[s], c->p, wk, c->st, mv);
    pthread_mutex_unlock(&P->mus[s]);
    return r;
}

static void par_witness(par_t *P, const cfg_t *c) {
    int32_t d = cfg_depth(c);
    int32_t ml = atomic_load_explicit(&P->maxlin, memory_order_relaxed);
    if (d < ml)
        return;
    if (d == ml && !P->wit_buf)
        return;
    pthread_mutex_lock(&P->wit_mu);
    wit_record(P->wit_buf, P->wit_cap, P->wit_len, &P->maxlin_plain, d, c);
    if (d > P->maxlin_plain)
        P->maxlin_plain = d;
    atomic_store_explicit(&P->maxlin, P->maxlin_plain,
                          memory_order_relaxed);
    pthread_mutex_unlock(&P->wit_mu);
}

/* Pop up to max_k configs off the top of the shared stack. */
static int par_pop(par_t *P, cfg_t *out, int max_k) {
    pthread_mutex_lock(&P->qmu);
    int k = (int)((P->q.len < (size_t)max_k) ? P->q.len : (size_t)max_k);
    for (int i = 0; i < k; i++)
        out[i] = P->q.items[--P->q.len];
    pthread_mutex_unlock(&P->qmu);
    return k;
}

/* Push k configs; 0 on OOM. */
static int par_push(par_t *P, const cfg_t *cs, int k) {
    pthread_mutex_lock(&P->qmu);
    for (int i = 0; i < k; i++) {
        if (!vec_push(&P->q, &cs[i])) {
            pthread_mutex_unlock(&P->qmu);
            return 0;
        }
    }
    if (P->q.len > P->q_peak)
        P->q_peak = P->q.len;
    pthread_mutex_unlock(&P->qmu);
    return 1;
}

static void *par_worker(void *arg) {
    par_t *P = (par_t *)arg;
    const tabs_t *T = &P->T;
    cfg_t *batch = (cfg_t *)malloc(sizeof(cfg_t) * PAR_POP_BATCH);
    cfg_t *succ = (cfg_t *)malloc(sizeof(cfg_t) * PAR_MAX_SUCC);
    if (!batch || !succ) {
        free(batch);
        free(succ);
        atomic_store(&P->decided, -3);
        return NULL;
    }
    int64_t local = 0, flushed = 0;
    while (!atomic_load_explicit(&P->decided, memory_order_relaxed)) {
        int k = par_pop(P, batch, PAR_POP_BATCH);
        if (k == 0) {
            if (atomic_load_explicit(&P->pending, memory_order_acquire)
                    == 0)
                break; /* nothing queued, nothing mid-expansion: done */
            struct timespec ts = {0, 50000}; /* 50 us */
            nanosleep(&ts, NULL);
            continue;
        }
        for (int bi = 0; bi < k; bi++) {
            if (atomic_load_explicit(&P->decided, memory_order_relaxed))
                break; /* decided != 0: refutation is off the table, so
                          the un-decremented pending is harmless */
            cfg_t *c = &batch[bi];
            local++;
            if ((local & 0x3FF) == 0) {
                atomic_fetch_add(&P->explored, local - flushed);
                flushed = local;
                if (atomic_load_explicit(&P->explored,
                                         memory_order_relaxed)
                        > P->max_configs ||
                    (P->cancel && *P->cancel)) {
                    atomic_store(&P->decided, -1);
                    break;
                }
            }
            int32_t wlim, min_ret, n_cand;
            cfg_bounds(T, c, &wlim, &min_ret, &n_cand);
            par_witness(P, c);
            int j0 = 0;
            cfg_t eager;
            int32_t eager_j = -1, eager_r = 0;
            if (P->romask && wlim > 0) {
                /* eager-read propagation (see the sequential DFS) */
                for (int32_t j = 0; j < wlim; j++) {
                    if (!((P->romask[c->p] >> j) & 1))
                        continue;
                    int r = cfg_try(T, c, wlim, min_ret, j, &eager);
                    if (r) {
                        j0 = j;
                        n_cand = j + 1;
                        eager_j = j;
                        eager_r = r;
                        break;
                    }
                }
            }
            int ns = 0;
            for (int j = j0; j < n_cand; j++) {
                cfg_t c2;
                int r;
                if (j == eager_j) {
                    c2 = eager;
                    r = eager_r;
                } else {
                    r = cfg_try(T, c, wlim, min_ret, j, &c2);
                }
                if (r == 0)
                    continue;
                if (r == 2) {
                    atomic_store(&P->decided, 1);
                    break;
                }
                int ins = par_insert(P, &c2);
                if (ins < 0) {
                    atomic_store(&P->decided, -3);
                    break;
                }
                if (ins)
                    succ[ns++] = c2;
            }
            if (atomic_load_explicit(&P->decided, memory_order_relaxed))
                break;
            if (ns) {
                /* reverse so the stack top is the lowest-j candidate
                 * (the real-time-first descent order) */
                for (int a = 0, b = ns - 1; a < b; a++, b--) {
                    cfg_t tmp = succ[a];
                    succ[a] = succ[b];
                    succ[b] = tmp;
                }
                atomic_fetch_add_explicit(&P->pending, ns,
                                          memory_order_release);
                if (!par_push(P, succ, ns)) {
                    atomic_store(&P->decided, -3);
                    break;
                }
            }
            atomic_fetch_sub_explicit(&P->pending, 1,
                                      memory_order_release);
        }
    }
    atomic_fetch_add(&P->explored, local - flushed);
    free(batch);
    free(succ);
    return NULL;
}

int wgl_check_dfs_par(
    int32_t nD, int32_t nO, int32_t S, int32_t W,
    const int32_t *invD, const int32_t *retD, const int32_t *opD,
    const int32_t *a1D, const int32_t *a2D,
    const int32_t *sufret,
    const int32_t *invO, const int32_t *opO,
    const int32_t *a1O, const int32_t *a2O,
    const int32_t *init_state,
    int32_t model_id, int64_t model_param,
    int64_t max_configs,
    int64_t *configs_explored, int32_t *frontier_max,
    int32_t *max_linearized,
    int32_t *wit_buf, int32_t wit_cap, int32_t *wit_len,
    const volatile int32_t *cancel,
    int32_t n_threads) {
    if (W > 64 || nO > 64 * NO_WORDS || S > S_MAX)
        return -2;
    *configs_explored = 0;
    *frontier_max = 0;
    *max_linearized = 0;
    if (wit_len)
        *wit_len = 0;
    if (nD == 0)
        return 1;
    if (n_threads < 1)
        n_threads = 1;
    if (n_threads > 64)
        n_threads = 64;

    par_t *P = (par_t *)calloc(1, sizeof(par_t));
    if (!P)
        return -3;
    tabs_t T = {nD, nO, S, W, invD, retD, opD, a1D, a2D, sufret,
                invO, opO, a1O, a2O, model_id, model_param, NULL};
    twins_t *Xp = twin_build(nD, nO, opD, a1D, a2D, invD,
                             opO, a1O, a2O, invO);
    T.tw = Xp;
    P->T = T;
    P->romask = romask_build(nD, model_id, opD);
    P->max_configs = max_configs;
    P->cancel = cancel;
    P->wit_buf = wit_buf;
    P->wit_cap = wit_cap;
    P->wit_len = wit_len;
    atomic_init(&P->pending, 0);
    atomic_init(&P->explored, 0);
    atomic_init(&P->decided, 0);
    atomic_init(&P->maxlin, 0);
    pthread_mutex_init(&P->wit_mu, NULL);
    pthread_mutex_init(&P->qmu, NULL);
    for (int i = 0; i < PAR_STRIPES; i++) {
        pthread_mutex_init(&P->mus[i], NULL);
        if (!dom_init(&P->sets[i], 1 << 8)) {
            for (int j = 0; j < i; j++)
                dom_free(&P->sets[j]);
            free(P);
            return -3;
        }
    }

    int verdict;
    {
        cfg_t root_cfg;
        memset(&root_cfg, 0, sizeof(root_cfg));
        memcpy(root_cfg.st, init_state, sizeof(int32_t) * (size_t)S);
        par_insert(P, &root_cfg);
        atomic_store(&P->pending, 1);
        if (!par_push(P, &root_cfg, 1)) {
            verdict = -3;
            goto out;
        }
    }

    {
        pthread_t tids[64];
        int started = 0;
        for (int i = 0; i < n_threads; i++) {
            if (pthread_create(&tids[i], NULL, par_worker, P) != 0)
                break;
            started++;
        }
        if (started == 0)
            atomic_store(&P->decided, -3);
        for (int i = 0; i < started; i++)
            pthread_join(tids[i], NULL);
        verdict = atomic_load(&P->decided); /* 0 = space exhausted */
    }

out:
    *configs_explored = atomic_load(&P->explored);
    *max_linearized = atomic_load(&P->maxlin);
    /* diagnostic: deepest the shared work stack ever got */
    *frontier_max = (int32_t)(P->q_peak > 0x7FFFFFFF
                                  ? 0x7FFFFFFF : P->q_peak);
    twin_free(Xp);
    free((void *)P->romask);
    free(P->q.items);
    for (int i = 0; i < PAR_STRIPES; i++) {
        dom_free(&P->sets[i]);
        pthread_mutex_destroy(&P->mus[i]);
    }
    pthread_mutex_destroy(&P->wit_mu);
    pthread_mutex_destroy(&P->qmu);
    free(P);
    return verdict;
}

int wgl_check(
    int32_t nD, int32_t nO, int32_t S, int32_t W,
    const int32_t *invD, const int32_t *retD, const int32_t *opD,
    const int32_t *a1D, const int32_t *a2D,
    const int32_t *sufret, /* [nD+1] suffix min of retD */
    const int32_t *invO, const int32_t *opO,
    const int32_t *a1O, const int32_t *a2O,
    const int32_t *init_state,
    int32_t model_id, int64_t model_param,
    int64_t max_configs,
    /* out */ int64_t *configs_explored, int32_t *frontier_max,
    int32_t *max_linearized) {
    if (W > 64 || nO > 64 * NO_WORDS || S > S_MAX)
        return -2;

    *configs_explored = 0;
    *frontier_max = 1;
    *max_linearized = 0;

    cfg_t start;
    memset(&start, 0, sizeof(start));
    memcpy(start.st, init_state, sizeof(int32_t) * (size_t)S);

    if (nD == 0)
        return 1; /* empty required set: trivially accepted */

    vec_t cur = {0}, nxt = {0};
    set_t seen;
    if (!set_init(&seen, 1 << 12))
        return -3;
    if (!vec_push(&cur, &start)) {
        set_free(&seen);
        return -3;
    }
    set_insert(&seen, &start, S);

    int verdict = 0;
    int64_t explored = 0;
    int lvl = 0;

    while (cur.len) {
        nxt.len = 0;
        int progressed = 0;
        for (size_t ci = 0; ci < cur.len && !verdict; ci++) {
            cfg_t *c = &cur.items[ci];
            explored++;
            if (explored > max_configs) {
                verdict = -1;
                break;
            }
            /* min completion among unlinearized determinate ops */
            int32_t tail = sufret[(c->p + W < nD) ? c->p + W : nD];
            int32_t min_ret = tail;
            int wlim = (nD - c->p < W) ? nD - c->p : W;
            for (int j = 0; j < wlim; j++) {
                if (!((c->win >> j) & 1) && retD[c->p + j] < min_ret)
                    min_ret = retD[c->p + j];
            }
            /* determinate candidates */
            for (int j = 0; j < wlim; j++) {
                if ((c->win >> j) & 1)
                    continue;
                int32_t row = c->p + j;
                /* allowed iff inv < min_ret, or own ret IS the min
                 * (event ranks are unique; inv[j] < ret[j] always) */
                if (invD[row] >= min_ret && retD[row] != min_ret)
                    continue;
                cfg_t c2 = *c;
                if (!step_model(model_id, model_param, c->st, opD[row],
                                a1D[row], a2D[row], c2.st))
                    continue;
                c2.win = c->win | (1ULL << j);
                /* renormalize prefix over trailing ones */
                while (c2.win & 1) {
                    c2.win >>= 1;
                    c2.p++;
                }
                if (c2.p >= nD) {
                    verdict = 1;
                    break;
                }
                int ins = set_insert(&seen, &c2, S);
                if (ins < 0) {
                    verdict = -3;
                    break;
                }
                if (ins && !vec_push(&nxt, &c2)) {
                    verdict = -3;
                    break;
                }
                if (ins)
                    progressed = 1;
            }
            if (verdict)
                break;
            /* open-op candidates */
            for (int o = 0; o < nO; o++) {
                if (open_test(c, o))
                    continue;
                if (invO[o] >= min_ret)
                    continue;
                cfg_t c2 = *c;
                if (!step_model(model_id, model_param, c->st, opO[o],
                                a1O[o], a2O[o], c2.st))
                    continue;
                open_set_bit(&c2, o);
                int ins = set_insert(&seen, &c2, S);
                if (ins < 0) {
                    verdict = -3;
                    break;
                }
                if (ins && !vec_push(&nxt, &c2)) {
                    verdict = -3;
                    break;
                }
                if (ins)
                    progressed = 1;
            }
        }
        if (verdict)
            break;
        if (progressed)
            lvl++;
        nxt.len = dominance_prune(nxt.items, nxt.len, S);
        if ((int32_t)nxt.len > *frontier_max)
            *frontier_max = (int32_t)nxt.len;
        /* swap */
        vec_t tmp = cur;
        cur = nxt;
        nxt = tmp;
        if (cur.len) {
            /* deepest prefix reached (diagnostic) */
            int32_t best = 0;
            for (size_t i = 0; i < cur.len; i++) {
                int32_t d = cur.items[i].p;
                uint64_t w = cur.items[i].win;
                while (w) {
                    d += (int32_t)(w & 1);
                    w >>= 1;
                }
                if (d > best)
                    best = d;
            }
            if (best > *max_linearized)
                *max_linearized = best;
        }
    }

    *configs_explored = explored;
    free(cur.items);
    free(nxt.items);
    set_free(&seen);
    return verdict;
}
