/* Native host pack of the port's fused pipeline (ctypes, no Python API).
 *
 * The port's own copy of the pack half and the JSON scan of the JAX
 * package's host runtime (attendance_tpu/native/hostpipe.c): each call fuses the per-frame host
 * work between the frame decode and the device dispatch into one pass
 * over the frame.  It maps lecture days through the dense day->bank LUT
 * and packs the lanes straight into the transfer buffer of one wire:
 *
 *   atp_max_key     the frame's max student id (the key width)
 *   atp_pack_words  word wire: bank << kw | key, all-ones padding
 *   atp_pack_bytes  bytes wire: u32 keys, then narrow bank ids
 *   atp_pack_seg    seg wire: per-bank counts, then a kb-bit key stream
 *                   stably sorted by bank, plus the lane permutation
 *   atp_delta_scan  delta wire, scan half: counting sort by bank, radix
 *                   sort by key inside each bank, per-lane deltas
 *   atp_bitpack     delta wire, pack half: fixed-width bit-pack
 *   atp_parse_json_events  the reference's per-event JSON wire into
 *                   the binary columns (a fixed-layout fast try, then the
 *                   general grammar; a payload outside the fast shape
 *                   returns its index and is parsed in Python)
 *   atp_dedup_last  the columnar store's read-time last-wins dedup
 *
 * The numpy equivalent (models/fused.py) is several passes with
 * frame-sized temporaries; this is about three loads and one store per
 * event with no allocation in the steady state.  A LUT miss returns the
 * missed event's index and the caller registers the day and retries; the
 * return codes are those of the JAX package's runtime, so the two
 * pipelines take the same path on the same frames.
 *
 * Plain C (c17), no dependencies; built by native/build.py with the
 * system C compiler (`cc -O3 -std=c17 -shared -fPIC -pthread`, no
 * -march=native: a library built on one host may be loaded on another),
 * loaded via ctypes (native/__init__.py).  The strided key/day pointers
 * take both planar frames (stride 4) and interleaved record frames
 * (stride 20).
 */

#include <pthread.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* Per-thread scratch arena: the packers need several MB of working
 * memory per frame, and a fresh malloc each call can cost more in page
 * faults than the passes that use it.  Slots grow monotonically while a
 * thread lives, so the bound is PER THREAD (largest frame that thread
 * ever packs); a pthread TSD destructor frees the whole arena at thread
 * exit, so embedders packing from short-lived worker threads do not
 * leak.  The arena struct is heap-owned and reached through the TSD key
 * — never through __thread storage, whose teardown order against TSD
 * destructors is unspecified. */
enum { SCRATCH_SLOTS = 6 };

typedef struct { void *p; size_t cap; } scratch_slot;
typedef struct { scratch_slot s[SCRATCH_SLOTS]; } scratch_arena;

static pthread_key_t g_scratch_key;
static pthread_once_t g_scratch_once = PTHREAD_ONCE_INIT;

static void scratch_destroy(void *arg) {
    scratch_arena *a = arg;
    for (int i = 0; i < SCRATCH_SLOTS; ++i) free(a->s[i].p);
    free(a);
}

static void scratch_key_init(void) {
    (void)pthread_key_create(&g_scratch_key, scratch_destroy);
}

static void *scratch(int slot, size_t bytes) {
    pthread_once(&g_scratch_once, scratch_key_init);
    scratch_arena *a = pthread_getspecific(g_scratch_key);
    if (!a) {
        a = calloc(1, sizeof *a);
        if (!a) return NULL;
        if (pthread_setspecific(g_scratch_key, a) != 0) {
            free(a);
            return NULL;
        }
    }
    if (a->s[slot].cap < bytes) {
        void *np_ = realloc(a->s[slot].p, bytes);
        if (!np_) return NULL;
        a->s[slot].p = np_;
        a->s[slot].cap = bytes;
    }
    return a->s[slot].p;
}

/* Strided uint32 load: byte base + element index * byte stride. */
static inline uint32_t ld_u32(const uint8_t *base, size_t i, size_t stride) {
    const uint8_t *p = base + i * stride;
    /* Little-endian assemble; compilers fold this to one load on LE
     * targets, and it is alignment-safe for the 20-byte ATB1 stride. */
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
           ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

/* Max student id over the frame (picks the packed key width). */
uint32_t atp_max_key(const uint8_t *keys, size_t n, size_t stride) {
    uint32_t mx = 0;
    if (stride == 4) { /* contiguous: let the compiler vectorize */
        const uint32_t *k = (const uint32_t *)keys;
        for (size_t i = 0; i < n; ++i)
            if (k[i] > mx) mx = k[i];
    } else {
        for (size_t i = 0; i < n; ++i) {
            uint32_t v = ld_u32(keys, i, stride);
            if (v > mx) mx = v;
        }
    }
    return mx;
}

/* Fused LUT bank-map + word pack.
 *
 * out[i] = lut[day[i] - day_base] << kw | key[i]   for i < n
 * out[i] = 0xFFFFFFFF (padding sentinel)           for n <= i < padded
 *
 * Returns 0 on success, 1 + the index of the first event whose day
 * fell outside the LUT window or had no registered bank (lut value
 * < 0), or -2 when some key did not fit kw bits.  The overflow check
 * rides the pack itself (one OR per event), so callers can try their
 * monotonic width hint straight away and skip the separate max-key
 * scan on every steady-state frame — the widen-and-retry only runs
 * when the population actually grows.  On a miss the caller registers
 * the missing day(s) in Python and calls again — out[] contents
 * before the miss index are valid but the call must be retried in
 * full. */
int64_t atp_pack_words(const uint8_t *keys, size_t key_stride,
                       const uint8_t *days, size_t day_stride,
                       size_t n, size_t padded,
                       const int32_t *lut, uint32_t day_base,
                       uint32_t lut_size, uint32_t kw,
                       uint32_t *out) {
    uint32_t overflow = 0;
    for (size_t i = 0; i < n; ++i) {
        uint32_t off = ld_u32(days, i, day_stride) - day_base;
        if (off >= lut_size) return 1 + (int64_t)i;
        int32_t bank = lut[off];
        if (bank < 0) return 1 + (int64_t)i;
        uint32_t k = ld_u32(keys, i, key_stride);
        overflow |= kw < 32 ? (k >> kw) : 0;
        out[i] = ((uint32_t)bank << kw) | k;
    }
    if (overflow) return -2;
    for (size_t i = n; i < padded; ++i)
        out[i] = 0xFFFFFFFFu;
    return 0;
}

/* Same fused pass for the 5-byte fallback wire (keys u32[padded] then
 * narrow bank ids), used when key+bank bits exceed one word.  w is the
 * bank id byte width (1, 2 or 4); padding lanes get zero keys and the
 * all-ones bank sentinel. */
int64_t atp_pack_bytes(const uint8_t *keys, size_t key_stride,
                       const uint8_t *days, size_t day_stride,
                       size_t n, size_t padded,
                       const int32_t *lut, uint32_t day_base,
                       uint32_t lut_size, uint32_t w,
                       uint8_t *out) {
    uint32_t *kv = (uint32_t *)out;
    uint8_t *bv = out + 4 * padded;
    for (size_t i = 0; i < n; ++i) {
        uint32_t off = ld_u32(days, i, day_stride) - day_base;
        if (off >= lut_size) return 1 + (int64_t)i;
        int32_t bank = lut[off];
        if (bank < 0) return 1 + (int64_t)i;
        kv[i] = ld_u32(keys, i, key_stride);
        if (w == 1) {
            bv[i] = (uint8_t)bank;
        } else if (w == 2) {
            ((uint16_t *)bv)[i] = (uint16_t)bank;
        } else {
            ((uint32_t *)bv)[i] = (uint32_t)bank;
        }
    }
    for (size_t i = n; i < padded; ++i) kv[i] = 0;
    if (w == 1) {
        for (size_t i = n; i < padded; ++i) bv[i] = 0xFFu;
    } else if (w == 2) {
        for (size_t i = n; i < padded; ++i)
            ((uint16_t *)bv)[i] = 0xFFFFu;
    } else {
        for (size_t i = n; i < padded; ++i)
            ((uint32_t *)bv)[i] = 0xFFFFFFFFu;
    }
    return 0;
}

/* Fused LUT bank-map + segmented bit-pack (the narrowest wire).
 *
 * Lays out ONE uint32 transfer buffer consumed by models.fused
 * .fused_step_seg: [per-bank event counts u32[num_banks] | bitstream of
 * kb bits per event, events stably sorted by bank | >= 2 guard words].
 * The bank id itself never crosses the link — the device recovers it
 * from the segment boundaries — so the wire is kb bits/event.
 *
 * out_perm[dst] = original index of the event packed at lane dst
 * (counting sort, stable within each bank).  The caller permutes the
 * store-bound columns with it so stored rows align with the device's
 * validity vector.
 *
 * Returns 0 on success, 1 + i on the first LUT miss (same retry
 * protocol as atp_pack_words), or -1 when scratch allocation fails /
 * num_banks exceeds the u16 scratch encoding (caller falls back to the
 * numpy packer).  buf_words is out_buf's uint32 length — the caller
 * (native/__init__.py) sizes it with models.fused.seg_buf_words, the
 * single definition of the wire layout; it is fully written here
 * (counts + zeroed stream + OR-scattered key bits). */
int64_t atp_pack_seg(const uint8_t *keys, size_t key_stride,
                     const uint8_t *days, size_t day_stride,
                     size_t n, size_t padded,
                     const int32_t *lut, uint32_t day_base,
                     uint32_t lut_size, uint32_t kb, uint32_t num_banks,
                     uint32_t *out_buf, size_t buf_words,
                     uint32_t *out_perm) {
    if (num_banks > 0xFFFFu || kb == 0 || kb > 32) return -1;
    /* The bitstream tail writes five bytes at bit (padded-1)*kb; make
     * sure the caller's buffer really covers stream + guard. */
    if (buf_words < num_banks + (padded * (size_t)kb + 31) / 32 + 2)
        return -1;
    uint16_t *bank_tmp = (uint16_t *)scratch(0, (n ? n : 1)
                                             * sizeof(uint16_t));
    uint32_t *offsets = (uint32_t *)scratch(1, num_banks
                                            * sizeof(uint32_t));
    if (!bank_tmp || !offsets)
        return -1;
    uint32_t *counts = out_buf;
    memset(out_buf, 0, buf_words * sizeof(uint32_t));
    for (size_t i = 0; i < n; ++i) {
        uint32_t off = ld_u32(days, i, day_stride) - day_base;
        if (off >= lut_size || lut[off] < 0)
            return 1 + (int64_t)i;
        bank_tmp[i] = (uint16_t)lut[off];
        ++counts[lut[off]];
    }
    uint32_t pos = 0;
    for (uint32_t b = 0; b < num_banks; ++b) {
        offsets[b] = pos;
        pos += counts[b];
    }
    uint8_t *stream = (uint8_t *)(out_buf + num_banks);
    uint32_t overflow = 0;
    for (size_t i = 0; i < n; ++i) {
        uint32_t dst = offsets[bank_tmp[i]]++;
        out_perm[dst] = (uint32_t)i;
        uint64_t bit = (uint64_t)dst * kb;
        uint32_t k = ld_u32(keys, i, key_stride);
        /* Overflow detection rides the pack (see atp_pack_words): a
         * key wider than kb bits would corrupt neighbouring lanes in
         * the bitstream, so the caller retries with a wider kb. */
        overflow |= kb < 32 ? (k >> kb) : 0;
        uint64_t v = (uint64_t)k << (bit & 7);
        uint8_t *p = stream + (bit >> 3);
        /* kb + 7 <= 39 bits: one unaligned u64 read-modify-write
         * covers any span (memcpy compiles to plain movs); the guard
         * words absorb the tail write.  Single-threaded, so the RMW on
         * shared boundary bytes between events is safe. */
        uint64_t cur;
        memcpy(&cur, p, 8);
        cur |= v;
        memcpy(p, &cur, 8);
    }
    return overflow ? -2 : 0;
}

/* Delta wire scan: sort by (bank, key) and emit the per-event deltas.
 *
 * Stable order: a counting sort by bank over the original order, then
 * an LSD byte-radix by key within each bank segment — equal (bank,
 * key) events keep append order, which is what keeps the columnar
 * store's last-write-wins ties identical across wires.  Outputs the
 * per-bank counts and base (first, smallest) keys, the delta stream
 * (0 at each segment start; the base rides in the header), the packed
 * lane -> original index permutation, and the widest delta's bit
 * count via *out_needed (the caller picks the wire width from it and
 * bit-packs with atp_bitpack).
 *
 * Returns 0 on success, 1 + i on the first LUT miss, -1 when scratch
 * allocation fails or num_banks exceeds the u16 scratch encoding. */
int64_t atp_delta_scan(const uint8_t *keys, size_t key_stride,
                       const uint8_t *days, size_t day_stride,
                       size_t n,
                       const int32_t *lut, uint32_t day_base,
                       uint32_t lut_size, uint32_t num_banks,
                       uint32_t *out_counts, uint32_t *out_bases,
                       uint32_t *out_deltas, uint32_t *out_perm,
                       uint32_t *out_needed) {
    if (num_banks > 0xFFFFu) return -1;
    uint16_t *bank_tmp = (uint16_t *)scratch(0, (n ? n : 1)
                                             * sizeof(uint16_t));
    uint32_t *offsets = (uint32_t *)scratch(1, num_banks
                                            * sizeof(uint32_t));
    /* skey holds the keys in bank order, then in (bank, key) order;
     * tkey/tidx are the radix ping-pong. */
    uint32_t *skey = (uint32_t *)scratch(2, (n ? n : 1)
                                         * sizeof(uint32_t));
    uint32_t *tkey = (uint32_t *)scratch(3, (n ? n : 1)
                                         * sizeof(uint32_t));
    uint32_t *tidx = (uint32_t *)scratch(4, (n ? n : 1)
                                         * sizeof(uint32_t));
    if (!bank_tmp || !offsets || !skey || !tkey || !tidx)
        return -1;
    memset(out_counts, 0, num_banks * sizeof(uint32_t));
    uint32_t maxkey = 0;
    for (size_t i = 0; i < n; ++i) {
        uint32_t off = ld_u32(days, i, day_stride) - day_base;
        if (off >= lut_size || lut[off] < 0)
            return 1 + (int64_t)i;
        bank_tmp[i] = (uint16_t)lut[off];
        ++out_counts[lut[off]];
        uint32_t k = ld_u32(keys, i, key_stride);
        if (k > maxkey) maxkey = k;
    }
    uint32_t pos = 0;
    for (uint32_t b = 0; b < num_banks; ++b) {
        offsets[b] = pos;
        pos += out_counts[b];
    }
    for (size_t i = 0; i < n; ++i) {
        uint32_t dst = offsets[bank_tmp[i]]++;
        skey[dst] = ld_u32(keys, i, key_stride);
        out_perm[dst] = (uint32_t)i;
    }
    /* offsets[b] is now each segment's END.  Radix-sort each segment
     * by key: 11-bit digits (2 passes cover 22-bit ids, 3 cover u32),
     * one combined histogram sweep for every digit, ping-pong buffers
     * with at most one final copy.  Stable, so equal keys keep append
     * order. */
    enum { DBITS = 11, DSIZE = 1 << DBITS, DMASK = DSIZE - 1 };
    int digits = 0;
    while ((maxkey >> (DBITS * digits)) != 0 && digits < 3) ++digits;
    uint32_t *hist = (uint32_t *)scratch(5, 3 * DSIZE * sizeof(uint32_t));
    if (!hist)
        return -1;
    uint32_t seg_start = 0;
    for (uint32_t b = 0; b < num_banks; ++b) {
        uint32_t seg_end = offsets[b];
        size_t m = seg_end - seg_start;
        uint32_t *sk = skey + seg_start, *si = out_perm + seg_start;
        if (m > 1 && digits > 0) {
            memset(hist, 0, digits * DSIZE * sizeof(uint32_t));
            for (size_t i = 0; i < m; ++i) {
                uint32_t k = sk[i];
                ++hist[k & DMASK];
                if (digits > 1) ++hist[DSIZE + ((k >> DBITS) & DMASK)];
                if (digits > 2) ++hist[2 * DSIZE + (k >> (2 * DBITS))];
            }
            uint32_t *ak = sk, *ai = si, *bk = tkey, *bi = tidx;
            for (int d = 0; d < digits; ++d) {
                uint32_t *h = hist + d * DSIZE;
                int shift = DBITS * d;
                if (h[(ak[0] >> shift) & DMASK] == m)
                    continue; /* uniform digit: nothing to move */
                uint32_t p = 0;
                for (int v = 0; v < DSIZE; ++v) {
                    uint32_t c = h[v];
                    h[v] = p;
                    p += c;
                }
                for (size_t i = 0; i < m; ++i) {
                    uint32_t dst = h[(ak[i] >> shift) & DMASK]++;
                    bk[dst] = ak[i];
                    bi[dst] = ai[i];
                }
                uint32_t *t = ak; ak = bk; bk = t;
                t = ai; ai = bi; bi = t;
            }
            if (ak != sk) {
                memcpy(sk, ak, m * sizeof(uint32_t));
                memcpy(si, ai, m * sizeof(uint32_t));
            }
        }
        out_bases[b] = m ? sk[0] : 0;
        seg_start = seg_end;
    }
    uint32_t maxd = 0;
    seg_start = 0;
    for (uint32_t b = 0; b < num_banks; ++b) {
        uint32_t seg_end = offsets[b];
        if (seg_end > seg_start) {
            out_deltas[seg_start] = 0;
            for (uint32_t i = seg_start + 1; i < seg_end; ++i) {
                uint32_t d = skey[i] - skey[i - 1];
                out_deltas[i] = d;
                if (d > maxd) maxd = d;
            }
        }
        seg_start = seg_end;
    }
    int bits = 0;
    while ((maxd >> bits) != 0) ++bits;
    *out_needed = bits ? (uint32_t)bits : 1;
    return 0;
}

/* Sequential fixed-width bit-pack of the delta stream (zeroed padding
 * tail).  Accumulator-based — no read-modify-writes, ~2 ops/event.
 * stream_words must be >= (padded*db + 31)/32 + 2 guard words. */
int64_t atp_bitpack(const uint32_t *vals, size_t n, size_t padded,
                    uint32_t db, uint32_t *stream, size_t stream_words) {
    if (db == 0 || db > 32) return -1;
    if (stream_words < (padded * (size_t)db + 31) / 32 + 2) return -1;
    uint64_t acc = 0;
    int nbits = 0;
    size_t w = 0;
    for (size_t i = 0; i < n; ++i) {
        acc |= (uint64_t)vals[i] << nbits;
        nbits += (int)db;
        while (nbits >= 32) {
            stream[w++] = (uint32_t)acc;
            acc >>= 32;
            nbits -= 32;
        }
    }
    if (nbits > 0)
        stream[w++] = (uint32_t)acc;
    memset(stream + w, 0, (stream_words - w) * sizeof(uint32_t));
    return 0;
}


/* ------------------------------------------------------------------ */
/* Schema-specific JSON event parser (the reference's wire format)     */
/* ------------------------------------------------------------------ */

/* The reference producer emits one JSON object per message:
 *   {"student_id": int, "timestamp": "YYYY-MM-DDTHH:MM:SS[.ffffff]",
 *    "lecture_id": "LECTURE_YYYYMMDD", "is_valid": bool,
 *    "event_type": "entry"|"exit"}
 * (reference data_generator.py:112-118,126-132,142-148).  Python
 * json.loads tops out ~340k events/s/thread; this scanner parses the
 * fixed schema at tens of millions/s.  It accepts any key order,
 * inter-token whitespace, unknown extra scalar keys, and both "T" and
 * " " date separators; anything outside the fast shape (string escape
 * sequences, timezone suffixes, nested values, non-calendar lecture
 * ids) aborts with the failing event's index and the caller re-parses
 * through the Python path — behavior-identical, just slower.
 */

static inline const uint8_t *skip_ws(const uint8_t *p, const uint8_t *end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
        ++p;
    return p;
}

/* Parse an unsigned decimal run; returns digits consumed (0 = fail). */
static inline int parse_uint(const uint8_t *p, const uint8_t *end,
                             uint64_t *out) {
    uint64_t v = 0;
    int n = 0;
    while (p + n < end && p[n] >= '0' && p[n] <= '9' && n < 19) {
        v = v * 10 + (uint64_t)(p[n] - '0');
        ++n;
    }
    *out = v;
    return n;
}

/* Days since the Unix epoch for a civil date (Howard Hinnant's
 * days_from_civil, public domain construction). */
static inline int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
    y -= m <= 2;
    int64_t era = (y >= 0 ? y : y - 399) / 400;
    int64_t yoe = y - era * 400;                                /* [0,399] */
    int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + doe - 719468;
}

/* "YYYY-MM-DD[T ]HH:MM:SS[.f{1,6}]" -> unix microseconds (UTC-pinned,
 * matching pipeline/events.iso_to_micros).  Returns chars consumed, 0 on any
 * deviation (including timezone suffixes — Python handles those). */
static int parse_iso_micros(const uint8_t *p, const uint8_t *end,
                            int64_t *out) {
    const uint8_t *q = p;
    uint64_t y, mo, d, h, mi, s, frac = 0;
    int n;
    if ((n = parse_uint(q, end, &y)) != 4) return 0;
    q += 4;
    if (q >= end || *q != '-') return 0;
    ++q;
    if ((n = parse_uint(q, end, &mo)) != 2) return 0;
    q += 2;
    if (q >= end || *q != '-') return 0;
    ++q;
    if ((n = parse_uint(q, end, &d)) != 2) return 0;
    q += 2;
    if (q >= end || (*q != 'T' && *q != ' ')) return 0;
    ++q;
    if ((n = parse_uint(q, end, &h)) != 2) return 0;
    q += 2;
    if (q >= end || *q != ':') return 0;
    ++q;
    if ((n = parse_uint(q, end, &mi)) != 2) return 0;
    q += 2;
    if (q >= end || *q != ':') return 0;
    ++q;
    if ((n = parse_uint(q, end, &s)) != 2) return 0;
    q += 2;
    if (q < end && *q == '.') {
        ++q;
        uint64_t scale = 100000;
        int nd = 0;
        while (q < end && *q >= '0' && *q <= '9') {
            if (nd < 6) { frac += (uint64_t)(*q - '0') * scale; scale /= 10; }
            ++nd; ++q;
        }
        /* Digits beyond 6 are ignored — exactly datetime.fromisoformat's
         * truncation (verified on 3.12). */
        if (nd == 0) return 0;
    }
    if (q < end && (*q == 'Z' || *q == '+' || *q == '-')) return 0;
    /* Reject everything datetime.fromisoformat rejects: year >= 1
     * (MINYEAR), month/day ranges per actual calendar (leap-aware),
     * hour<=23, min/sec<=59. */
    if (y < 1 || mo < 1 || mo > 12 || d < 1 || h > 23 || mi > 59 || s > 59)
        return 0;
    {
        static const uint8_t mdays[12] =
            {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
        uint64_t dim = mdays[mo - 1];
        if (mo == 2 && (y % 4 == 0 && (y % 100 != 0 || y % 400 == 0)))
            dim = 29;
        if (d > dim) return 0;
    }
    *out = (days_from_civil((int64_t)y, (int64_t)mo, (int64_t)d) * 86400
            + (int64_t)h * 3600 + (int64_t)mi * 60 + (int64_t)s) * 1000000
           + (int64_t)frac;
    return (int)(q - p);
}

/* Scan a JSON string (plain printable ASCII only); returns span
 * excluding the quotes via (start, len), and chars consumed including
 * quotes.  Escapes, raw control characters (json.loads rejects those),
 * and non-ASCII bytes (json.loads validates UTF-8; we don't) all bail
 * to the Python path — the fast path must never accept a payload the
 * Python codec refuses, nor refuse differently than it would. */
static int parse_plain_string(const uint8_t *p, const uint8_t *end,
                              const uint8_t **s, uint32_t *len) {
    if (p >= end || *p != '"') return 0;
    const uint8_t *q = p + 1;
    while (q < end && *q != '"') {
        if (*q == '\\' || *q < 0x20 || *q >= 0x80) return 0;
        ++q;
    }
    if (q >= end) return 0;
    *s = p + 1;
    *len = (uint32_t)(q - p - 1);
    return (int)(q - p + 1);
}

/* "LECTURE_YYYYMMDD"-style tail -> day code, mirroring
 * pipeline/events.lecture_to_day's digit cases (8-digit calendar, 9-digit
 * hash-range round-trip). Non-digit tails need murmur3 -> bail. */
static int lecture_day_from_id(const uint8_t *s, uint32_t len,
                               uint32_t *out) {
    uint32_t tail_start = 0;
    for (uint32_t i = 0; i < len; ++i)
        if (s[i] == '_') tail_start = i + 1;
    uint32_t tlen = len - tail_start;
    const uint8_t *t = s + tail_start;
    uint64_t v = 0;
    if (tlen == 0 || tlen > 9) return 0;
    for (uint32_t i = 0; i < tlen; ++i) {
        if (t[i] < '0' || t[i] > '9') return 0;
        v = v * 10 + (uint64_t)(t[i] - '0');
    }
    if (tlen == 8) { *out = (uint32_t)v; return 1; }
    if (tlen == 9 && v >= 100000000ull && v < 100000000ull + (1ull << 26)) {
        *out = (uint32_t)v;
        return 1;
    }
    return 0;
}

/* Skip one non-string JSON scalar, validating its grammar: null, true,
 * false, or a number -?(0|[1-9][0-9]*)(.[0-9]+)?([eE][+-]?[0-9]+)?.
 * Returns chars consumed, 0 on anything json.loads would reject (bare
 * words, leading-zero numbers) — the fast path must never accept
 * payloads the Python codec refuses. */
static int skip_scalar(const uint8_t *p, const uint8_t *end) {
    const uint8_t *q = p;
    if (end - q >= 4 && q[0] == 'n' && q[1] == 'u' && q[2] == 'l'
        && q[3] == 'l') return 4;
    if (end - q >= 4 && q[0] == 't' && q[1] == 'r' && q[2] == 'u'
        && q[3] == 'e') return 4;
    if (end - q >= 5 && q[0] == 'f' && q[1] == 'a' && q[2] == 'l'
        && q[3] == 's' && q[4] == 'e') return 5;
    if (q < end && *q == '-') ++q;
    if (q >= end || *q < '0' || *q > '9') return 0;
    if (*q == '0') {
        ++q;
    } else {
        while (q < end && *q >= '0' && *q <= '9') ++q;
    }
    if (q < end && *q == '.') {
        ++q;
        if (q >= end || *q < '0' || *q > '9') return 0;
        while (q < end && *q >= '0' && *q <= '9') ++q;
    }
    if (q < end && (*q == 'e' || *q == 'E')) {
        ++q;
        if (q < end && (*q == '+' || *q == '-')) ++q;
        if (q >= end || *q < '0' || *q > '9') return 0;
        while (q < end && *q >= '0' && *q <= '9') ++q;
    }
    return (int)(q - p);
}

static inline int key_is(const uint8_t *k, uint32_t klen, const char *name) {
    uint32_t n = 0;
    while (name[n]) ++n;
    if (klen != n) return 0;
    for (uint32_t i = 0; i < n; ++i)
        if (k[i] != (uint8_t)name[i]) return 0;
    return 1;
}

/* Parse n JSON event payloads (concatenated in buf, event i spanning
 * [offs[i], offs[i] + lens[i])) into the binary columns.  flags bit0 =
 * is_valid, bit1 = exit.  Returns 0, or 1 + index of the first payload
 * that falls outside the fast shape (caller re-parses via Python). */
/* Fixed-layout fast path: the reference producer emits every event via
 * json.dumps with default separators, so the overwhelming majority of
 * payloads match ONE byte layout:
 *   {"student_id": N, "timestamp": "T", "lecture_id": "L",
 *    "is_valid": B, "event_type": "E"}
 * This path memcmp's the literal fragments and parses only the value
 * spans; any deviation (key order, spacing, escapes, extra keys)
 * returns nonzero and the caller falls through to the general grammar
 * — behavior is identical, this is purely a cheaper first try. */
#define ATP_LIT(lit)                                                   \
    do {                                                               \
        size_t L_ = sizeof(lit) - 1;                                   \
        if ((size_t)(end - p) < L_ || memcmp(p, lit, L_)) return 1;    \
        p += L_;                                                       \
    } while (0)

static int parse_fixed_layout(const uint8_t *p, const uint8_t *end,
                              uint32_t *student, uint32_t *day,
                              int64_t *micros, uint8_t *flags) {
    ATP_LIT("{\"student_id\": ");
    uint64_t v;
    int d = parse_uint(p, end, &v);
    if (!d || (d > 1 && *p == '0')) return 1;
    p += d;
    ATP_LIT(", \"timestamp\": ");
    /* String fields go through parse_plain_string — ONE definition of
     * the acceptance predicate (escapes, control bytes, non-ASCII all
     * bail to the fallback, which mirrors json.loads). The empty-span
     * guard closes the 0 == 0 hole: parse_iso_micros returns 0 for
     * failure AND consumes 0 bytes of an empty string, but Python's
     * fromisoformat("") raises, so empty must never fast-parse. */
    const uint8_t *ts;
    uint32_t tslen;
    int c1 = parse_plain_string(p, end, &ts, &tslen);
    if (!c1) return 1;
    int64_t us;
    if (tslen == 0 || parse_iso_micros(ts, ts + tslen, &us) != (int)tslen)
        return 1;
    p += c1;
    ATP_LIT(", \"lecture_id\": ");
    const uint8_t *lid;
    uint32_t lidlen;
    int c2 = parse_plain_string(p, end, &lid, &lidlen);
    if (!c2) return 1;
    uint32_t day_v;
    if (!lecture_day_from_id(lid, lidlen, &day_v)) return 1;
    p += c2;
    ATP_LIT(", \"is_valid\": ");
    uint8_t fl;
    if (end - p >= 4 && !memcmp(p, "true", 4)) { fl = 1; p += 4; }
    else if (end - p >= 5 && !memcmp(p, "false", 5)) { fl = 0; p += 5; }
    else return 1;
    ATP_LIT(", \"event_type\": \"");
    if (end - p >= 6 && !memcmp(p, "entry\"", 6)) { p += 6; }
    else if (end - p >= 5 && !memcmp(p, "exit\"", 5)) { fl |= 2; p += 5; }
    else return 1;
    if (p >= end || *p != '}') return 1;
    ++p;
    if (p != end) return 1;  /* trailing bytes: general path decides */
    *student = (uint32_t)(v & 0xFFFFFFFFu);
    *micros = us;
    *day = day_v;
    *flags = fl;
    return 0;
}

static int parse_one_json_event(const uint8_t *p, const uint8_t *end,
                                uint32_t *student, uint32_t *day,
                                int64_t *micros, uint8_t *flags) {
    if (!parse_fixed_layout(p, end, student, day, micros, flags))
        return 0;
    int seen = 0; /* bit per required field */
    int after_comma = 0;
    uint8_t fl = 0;
    p = skip_ws(p, end);
    if (p >= end || *p != '{') return 1;
    ++p;
    for (;;) {
        p = skip_ws(p, end);
        if (p < end && *p == '}') {
            /* json.loads rejects a trailing comma before '}'. */
            if (after_comma) return 1;
            ++p;
            break;
        }
        const uint8_t *k;
        uint32_t klen;
        int c = parse_plain_string(p, end, &k, &klen);
        if (!c) return 1;
        p = skip_ws(p + c, end);
        if (p >= end || *p != ':') return 1;
        p = skip_ws(p + 1, end);
        if (key_is(k, klen, "student_id")) {
            uint64_t v;
            int d_ = parse_uint(p, end, &v);
            /* JSON forbids leading zeros ("007"): json.loads
             * raises, so the fast path must refuse too. */
            if (!d_ || (d_ > 1 && *p == '0')) return 1;
            *student = (uint32_t)(v & 0xFFFFFFFFu);
            p += d_;
            seen |= 1;
        } else if (key_is(k, klen, "timestamp")) {
            const uint8_t *s;
            uint32_t slen;
            int c2 = parse_plain_string(p, end, &s, &slen);
            if (!c2) return 1;
            int64_t us;
            /* slen == 0 guard: parse_iso_micros returns 0 on failure,
             * which equals the consumed count of an empty string —
             * but fromisoformat("") raises in the Python codec, so
             * empty must be refused here too. */
            if (slen == 0
                || parse_iso_micros(s, s + slen, &us) != (int)slen)
                return 1;
            *micros = us;
            p += c2;
            seen |= 2;
        } else if (key_is(k, klen, "lecture_id")) {
            const uint8_t *s;
            uint32_t slen;
            int c2 = parse_plain_string(p, end, &s, &slen);
            if (!c2) return 1;
            if (!lecture_day_from_id(s, slen, day))
                return 1;
            p += c2;
            seen |= 4;
        } else if (key_is(k, klen, "is_valid")) {
            /* Duplicate keys: json.loads keeps the LAST value, so
             * the flag bit is overwritten, never OR-accumulated. */
            if (end - p >= 4 && p[0] == 't' && p[1] == 'r'
                && p[2] == 'u' && p[3] == 'e') {
                fl = (uint8_t)((fl & ~1u) | 1u); p += 4;
            } else if (end - p >= 5 && p[0] == 'f' && p[1] == 'a'
                       && p[2] == 'l' && p[3] == 's' && p[4] == 'e') {
                fl = (uint8_t)(fl & ~1u); p += 5;
            } else {
                return 1;
            }
            seen |= 8;
        } else if (key_is(k, klen, "event_type")) {
            const uint8_t *s;
            uint32_t slen;
            int c2 = parse_plain_string(p, end, &s, &slen);
            if (!c2) return 1;
            if (slen == 4 && s[0] == 'e' && s[1] == 'x' && s[2] == 'i'
                && s[3] == 't')
                fl = (uint8_t)((fl & ~2u) | 2u);  /* last wins */
            else if (slen == 5 && s[0] == 'e' && s[1] == 'n'
                     && s[2] == 't' && s[3] == 'r' && s[4] == 'y')
                fl = (uint8_t)(fl & ~2u);
            else
                return 1;
            p += c2;
            seen |= 16;
        } else {
            /* Unknown key: skip a grammar-checked scalar value
             * (string without escapes, number, true/false/null);
             * anything nested or malformed goes to the Python
             * path. */
            if (p < end && *p == '"') {
                const uint8_t *s;
                uint32_t slen;
                int c2 = parse_plain_string(p, end, &s, &slen);
                if (!c2) return 1;
                p += c2;
            } else {
                int c2 = skip_scalar(p, end);
                if (!c2) return 1;
                p += c2;
            }
        }
        p = skip_ws(p, end);
        if (p < end && *p == ',') { ++p; after_comma = 1; continue; }
        if (p < end && *p == '}') { ++p; break; }
        return 1;
    }
    p = skip_ws(p, end);
    if (p != end || seen != 31) return 1;
    *flags = fl;
    return 0;
}

int64_t atp_parse_json_events(const uint8_t *buf, const uint64_t *offs,
                              const uint32_t *lens, size_t n,
                              uint32_t *student, uint32_t *day,
                              int64_t *micros, uint8_t *flags) {
    for (size_t i = 0; i < n; ++i) {
        const uint8_t *p = buf + offs[i];
        if (parse_one_json_event(p, p + lens[i], &student[i], &day[i],
                                 &micros[i], &flags[i]))
            return 1 + (int64_t)i;
    }
    return 0;
}

/* ------------------------------------------------------------------ */
/* Columnar-store compaction: last-wins primary-key dedup              */
/* ------------------------------------------------------------------ */

/* The columnar store deduplicates on the Cassandra primary key
 * (lecture_day, micros, student_id), keeping the LAST appended row
 * (last-write-wins upsert).  The numpy path is a full lexsort; this pass
 * is a single-scan open-addressing upsert (key -> last index) plus a
 * radix sort of the surviving indices.
 *
 * Returns the number of kept rows (their original indices written to
 * out_idx in ascending order = append order), or -1 on allocation
 * failure. */

static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 33; x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33; x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

/* LSD radix sort; returns 0, or -1 on allocation failure (unsorted
 * indices would break the append-order contract). */
static int radix_sort_u32(uint32_t *a, size_t n) {
    uint32_t *tmp = (uint32_t *)malloc(n * sizeof(uint32_t));
    if (!tmp)
        return -1;
    size_t count[256];
    for (int shift = 0; shift < 32; shift += 8) {
        memset(count, 0, sizeof(count));
        for (size_t i = 0; i < n; ++i)
            ++count[(a[i] >> shift) & 0xFF];
        size_t pos = 0;
        for (int b = 0; b < 256; ++b) {
            size_t c = count[b];
            count[b] = pos;
            pos += c;
        }
        for (size_t i = 0; i < n; ++i)
            tmp[count[(a[i] >> shift) & 0xFF]++] = a[i];
        memcpy(a, tmp, n * sizeof(uint32_t));
    }
    free(tmp);
    return 0;
}

typedef struct {
    uint64_t mic;
    uint64_t ds;  /* day << 32 | sid */
    uint32_t idx; /* 0xFFFFFFFF = empty */
    uint32_t pad;
} dedup_entry;

int64_t atp_dedup_last(const uint32_t *day, const uint32_t *sid,
                       const int64_t *micros, size_t n,
                       uint32_t *out_idx) {
    if (n == 0) return 0;
    if (n >= 0xFFFFFFFFu) return -1; /* idx sentinel reserves 2^32-1 */
    size_t cap = 1;
    while (cap < n * 2) cap <<= 1;
    /* One interleaved 24-byte entry per slot: a probe touches ONE cache
     * line, not three arrays — this pass is DRAM-latency-bound. */
    dedup_entry *tab = (dedup_entry *)malloc(cap * sizeof(dedup_entry));
    if (!tab) return -1;
#ifdef __linux__
    /* Transparent huge pages cut the TLB-miss-per-probe cost of the
     * random access pattern on a large table. Advisory: failure is
     * fine. */
    {
        extern int madvise(void *, size_t, int);
        madvise(tab, cap * sizeof(dedup_entry), 14 /* MADV_HUGEPAGE */);
    }
#endif
    memset(tab, 0xFF, cap * sizeof(dedup_entry));
    uint64_t mask = (uint64_t)cap - 1;
    /* Software-pipelined probe: hash a window ahead and prefetch its
     * slots so the DRAM fetches overlap. */
    enum { PF = 16 };
    uint64_t w_mic[PF], w_ds[PF], w_h[PF];
    for (size_t base = 0; base < n; base += PF) {
        size_t m = n - base < PF ? n - base : PF;
        for (size_t j = 0; j < m; ++j) {
            uint64_t mic = (uint64_t)micros[base + j];
            uint64_t ds = ((uint64_t)day[base + j] << 32)
                          | (uint64_t)sid[base + j];
            uint64_t h = mix64(mic ^ mix64(ds)) & mask;
            w_mic[j] = mic;
            w_ds[j] = ds;
            w_h[j] = h;
            __builtin_prefetch(&tab[h], 1, 1);
        }
        for (size_t j = 0; j < m; ++j) {
            uint64_t mic = w_mic[j], ds = w_ds[j], h = w_h[j];
            for (;;) {
                dedup_entry *e = &tab[h];
                if (e->idx == 0xFFFFFFFFu) {
                    e->mic = mic;
                    e->ds = ds;
                    e->idx = (uint32_t)(base + j);
                    break;
                }
                if (e->mic == mic && e->ds == ds) {
                    e->idx = (uint32_t)(base + j); /* last write wins */
                    break;
                }
                h = (h + 1) & mask;
            }
        }
    }
    size_t kept = 0;
    for (size_t h = 0; h < cap; ++h)
        if (tab[h].idx != 0xFFFFFFFFu)
            out_idx[kept++] = tab[h].idx;
    free(tab);
    if (radix_sort_u32(out_idx, kept) != 0)
        return -1;
    return (int64_t)kept;
}
