// Native host runtime for peritext_tpu_torch (a copy of the reference
// package's peritext_tpu/native/src/native.cpp, kept diffable against it).
//
// The card owns op application (the CUDA insert kernel and torch ops); the
// host owns the irregular work around it.  Two of those paths are hot
// enough at scale to be native (host-side causal scheduling runs per
// document per round; the wire codec runs per change batch on every hop):
//
//  1. pt_causal_schedule — deterministic topological schedule of a change
//     set against a vector clock (the C++ twin of
//     peritext_tpu_torch/parallel/causal.py::causal_schedule; the reference's
//     catch-and-requeue loop is test/merge.ts:4-23).
//  2. pt_varint_encode / pt_varint_decode — zigzag-varint packing of int32
//     streams, the payload core of the binary change-frame codec
//     (peritext_tpu_torch/parallel/codec.py).
//
// Plain C ABI throughout: the Python side binds with ctypes (no pybind11 in
// the image), and everything crossing the boundary is int32/uint8 arrays.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {
inline int64_t key_of(int32_t actor, int32_t seq) {
    return (static_cast<int64_t>(actor) << 32) | static_cast<uint32_t>(seq);
}

// ---- wire v2 change/op walk (codec.py is the format's reference) ---------
//
// v2 delta-encodes against frame-scoped context so the hot shapes cost a
// few bytes/op: change headers carry a combo int (actor strid << 4 | flags
// eliding dseq/dstart/deps/nops), dep sets transmit only changed vector
// clock entries, op ids/objects/insert-refs elide behind per-op flags, and
// explicit element counters are deltas against the op's own counter.
// This struct is the decoder's running context (one per frame).
struct WireV2Ctx {
    // change-header state, indexed by frame string id
    std::vector<int32_t> last_seq, prev_end, dep_base;
    std::vector<uint8_t> own_elided, has_dep_set;
    std::vector<std::vector<std::pair<int32_t, int32_t>>> dep_set;  // (strid, seq)
    // duplicate-dep detection scratch (epoch-stamped, O(1) reset per change)
    std::vector<int32_t> dep_seen;
    int32_t dep_epoch = 0;
    // op state
    bool has_prev_op = false;
    int32_t prev_obj = 0;      // packed (-1 ROOT)
    bool prev_obj_bad = false;
    int32_t prev_opid = 0;     // packed
    bool prev_opid_bad = false;
    explicit WireV2Ctx(int32_t n_strings)
        : last_seq(n_strings, 0), prev_end(n_strings, 0), dep_base(n_strings, 0),
          own_elided(n_strings, 0), has_dep_set(n_strings, 0),
          dep_set(n_strings), dep_seen(n_strings, -1) {}
};

// v2 per-op flags (codec.py _F_*)
constexpr int32_t kFOpidSeq = 1, kFObjPrev = 2, kFRefPrev = 4, kFRefHead = 8;
// v2 change-header flags (codec.py _H_*)
constexpr int32_t kHDseqZero = 1, kHDstartZero = 2, kHDepsSame = 4, kHNopsOne = 8;
// internal op-row kind for a native-decoded makeList (codec v2 encodes the
// doc's makeList as map-op kind 5 with flag kFRefHead instead of a JSON
// spillover; the Python ingest layer adopts it exactly like the JSON form)
constexpr int32_t kKindMakeList = 7;

// Output sinks + cursors shared by the two entry points (single-frame
// parse writes from 0; bulk parse appends at its global cursors).
struct WireOut {
    int32_t* ch_actor; int32_t* ch_seq;
    int32_t* dep_off; int32_t* dep_actor; int32_t* dep_seq; int64_t dep_cap;
    int32_t* ops_off; int32_t* ops; int64_t op_cap;
    int32_t* cnt_ins; int32_t* cnt_del; int32_t* cnt_mark; int32_t* cnt_map;
};

// Decode a v2 payload (codec.py encode_frame v2 is the format reference).
// s2a maps frame string ids to declared actor interner ids (>=1) or -1.
// str_base globalizes string ids stored into op rows (0 for single-frame).
// Returns 0 ok, 1 corrupt/malformed, -2 dep capacity, -3 op capacity;
// cursors nc/nd/no advance only as records are written (caller rolls back
// on nonzero).
int32_t walk_v2(const int32_t* vals, int64_t n_vals, int32_t n_changes,
                const int32_t* s2a, int32_t n_strings, int32_t n_declared,
                int32_t actor_bits, int32_t max_ctr, int32_t str_base,
                WireOut& o, int64_t& nc, int64_t& nd, int64_t& no) {
    WireV2Ctx ctx(n_strings);
    const int64_t nd0 = nd;  // bulk parses share nd across frames: budget
                             // must meter THIS frame's emission only
    int64_t p = 0;
    auto take = [&](int64_t k) -> const int32_t* {
        if (p + k > n_vals) return nullptr;
        const int32_t* ptr = vals + p;
        p += k;
        return ptr;
    };
    auto actor_of = [&](int32_t strid) -> int32_t {
        if (strid < 0 || strid >= n_strings) return -2;
        return s2a[strid];
    };
    auto pack = [&](int64_t ctr, int32_t strid, bool* bad) -> int32_t {
        const int32_t a = actor_of(strid);
        if (a == -2) { *bad = true; return 0; }
        if (a < 0 || ctr < 0 || ctr > max_ctr) { *bad = true; return 0; }
        return (static_cast<int32_t>(ctr) << actor_bits) | a;
    };

    for (int32_t c = 0; c < n_changes; ++c) {
        const int32_t* cb = take(1);
        if (!cb) return 1;
        const int32_t strid = *cb >> 4, hflags = *cb & 15;
        if (*cb < 0 || strid >= n_strings) return 1;
        int32_t dseq = 0, dstart = 0;
        if (!(hflags & kHDseqZero)) {
            const int32_t* v = take(1); if (!v) return 1; dseq = *v;
        }
        if (!(hflags & kHDstartZero)) {
            const int32_t* v = take(1); if (!v) return 1; dstart = *v;
        }
        // wire deltas are attacker-controlled: do the reconstruction in
        // int64 and reject anything leaving int32 range as corrupt (signed
        // int32 overflow would be UB, and a wrapped value would propagate
        // downstream instead of flagging the frame)
        const int64_t seq64 =
            static_cast<int64_t>(ctx.last_seq[strid]) + 1 + dseq;
        const int64_t start64 =
            static_cast<int64_t>(ctx.prev_end[strid]) + dstart;
        if (seq64 < 0 || seq64 > INT32_MAX || start64 < 0 ||
            start64 > INT32_MAX) {
            return 1;
        }
        const int32_t seq = static_cast<int32_t>(seq64);
        const int32_t start_op = static_cast<int32_t>(start64);
        const int32_t a = actor_of(strid);
        o.ch_actor[nc] = a;  // may be -1: undeclared actor, caller demotes
        o.ch_seq[nc] = seq;

        int32_t own;
        if (hflags & kHDepsSame) {
            if (!ctx.has_dep_set[strid]) return 1;
            own = ctx.own_elided[strid];
        } else {
            const int32_t* v = take(1);
            if (!v || *v < 0) return 1;
            own = *v & 1;
            const bool delta = (*v >> 1) & 1;
            const int32_t count = *v >> 2;
            // Dep sets referencing far more actors than the session declares
            // leave the fast path by DEMOTION (the object path's Python
            // decoder accepts them — same route as undeclared-actor deps),
            // but their storage is bounded here: without a cap, a small
            // DEPS_SAME-spamming frame forces multi-GB dep output and
            // quadratic re-emission (review finding r3).  Entries beyond the
            // cap are consumed from the stream (alignment) but not stored.
            const int32_t dep_store_cap = n_declared + 64;
            auto& entries = ctx.dep_set[strid];
            if (delta) {
                if (!ctx.has_dep_set[strid]) return 1;
                for (int32_t i = 0; i < count; ++i) {
                    const int32_t* dp = take(2);
                    if (!dp) return 1;
                    const int32_t da = dp[0];
                    if (da < 0 || da >= n_strings) return 1;
                    bool found = false;
                    for (auto& e : entries) {
                        if (e.first == da) {
                            const int64_t ds64 =
                                static_cast<int64_t>(e.second) + dp[1];
                            if (ds64 < 0 || ds64 > INT32_MAX) return 1;
                            e.second = static_cast<int32_t>(ds64);
                            ctx.dep_base[da] = e.second;
                            found = true;
                            break;
                        }
                    }
                    if (!found) return 1;
                }
            } else {
                entries.clear();
                ++ctx.dep_epoch;
                for (int32_t i = 0; i < count; ++i) {
                    const int32_t* dp = take(2);
                    if (!dp) return 1;
                    const int32_t da = dp[0];
                    if (da < 0 || da >= n_strings) return 1;
                    // duplicate dep actors never occur in a legit encoding
                    // (deps are a per-actor map, and codec.py rejects dups
                    // identically): corrupt
                    if (ctx.dep_seen[da] == ctx.dep_epoch) return 1;
                    ctx.dep_seen[da] = ctx.dep_epoch;
                    const int64_t ds64 =
                        static_cast<int64_t>(
                            std::max(ctx.dep_base[da], ctx.last_seq[da])) +
                        dp[1];
                    if (ds64 < 0 || ds64 > INT32_MAX) return 1;
                    if (static_cast<int32_t>(entries.size()) < dep_store_cap) {
                        entries.push_back({da, static_cast<int32_t>(ds64)});
                    } else {
                        // over the storage cap: demote this doc off the
                        // fast path (decode_frame handles the full set)
                        o.ch_actor[nc] = -1;
                    }
                    ctx.dep_base[da] = static_cast<int32_t>(ds64);
                }
            }
            ctx.own_elided[strid] = static_cast<uint8_t>(own);
            ctx.has_dep_set[strid] = 1;
        }
        // Total-emission budget (review finding r3 medium): every change
        // re-emits its stored dep set, so a frame of tiny DEPS_SAME headers
        // otherwise forces ~(n_declared+64) output entries per ~1 payload
        // int, which the host's capacity doubling obligingly allocates.
        // Over-budget changes are DEMOTED (ch_actor = -1), not rejected —
        // huge-actor sessions are valid data and the object path decodes
        // them in shared O(1)-per-change memory.
        const int64_t dep_emit_budget =
            std::min<int64_t>(64 * n_vals + 4096, 16000000);
        const auto& emit_set = ctx.dep_set[strid];
        const int64_t need =
            (own ? 1 : 0) + static_cast<int64_t>(emit_set.size());
        if ((nd - nd0) + need > dep_emit_budget) {
            o.ch_actor[nc] = -1;
        } else {
            if (own) {
                if (a < 0) {
                    o.ch_actor[nc] = -1;  // dep on undeclared (own) actor
                } else {
                    if (nd >= o.dep_cap) return -2;
                    o.dep_actor[nd] = a;
                    o.dep_seq[nd] = seq - 1;
                    ++nd;
                }
            }
            for (const auto& e : emit_set) {
                const int32_t da = actor_of(e.first);
                if (da == -2) return 1;
                if (da < 0) { o.ch_actor[nc] = -1; continue; }
                if (nd >= o.dep_cap) return -2;
                o.dep_actor[nd] = da;
                o.dep_seq[nd] = e.second;
                ++nd;
            }
        }
        o.dep_off[nc + 1] = static_cast<int32_t>(nd);

        int32_t nops = 1;
        if (!(hflags & kHNopsOne)) {
            const int32_t* v = take(1);
            if (!v || *v < 0) return 1;
            nops = *v;
        }
        const int64_t end64 = static_cast<int64_t>(start_op) + nops;
        if (end64 > INT32_MAX) return 1;
        ctx.last_seq[strid] = seq;
        ctx.prev_end[strid] = static_cast<int32_t>(end64);

        int32_t ci = 0, cd = 0, cm = 0, cp = 0;
        for (int32_t k = 0; k < nops; ++k) {
            if (no >= o.op_cap) return -3;
            int32_t* row = o.ops + no * 10;
            for (int i = 0; i < 10; ++i) row[i] = 0;
            const int32_t* fp = take(1);
            if (!fp || *fp < 0) return 1;
            const int32_t kind = *fp & 7, of = *fp >> 3;
            bool bad = (o.ch_actor[nc] < 0);
            if (kind == 4) {  // JSON spillover (no flags, no ctx update)
                if (of) return 1;
                const int32_t* b = take(1);
                if (!b) return 1;
                if (b[0] < 0 || b[0] >= n_strings) return 1;
                row[0] = 3;
                row[3] = str_base + b[0];
            } else {
                if (of >> 4) return 1;
                if ((of & kFRefPrev) && kind != 0) return 1;
                if ((of & kFRefHead) && kind != 0 && kind != 5) return 1;
                if ((of & kFRefPrev) && (of & kFRefHead)) return 1;
                int32_t obj;
                bool obj_bad = false;
                if (of & kFObjPrev) {
                    if (!ctx.has_prev_op) return 1;
                    obj = ctx.prev_obj;
                    obj_bad = ctx.prev_obj_bad;
                } else {
                    const int32_t* b = take(3);
                    if (!b) return 1;
                    obj = (b[0] == 0) ? -1 : pack(b[1], b[2], &obj_bad);
                }
                if (obj_bad) bad = true;
                int64_t op_ctr;
                int32_t op_strid;
                if (of & kFOpidSeq) {
                    op_ctr = static_cast<int64_t>(start_op) + k;
                    op_strid = strid;
                } else {
                    const int32_t* b = take(2);
                    if (!b) return 1;
                    op_ctr = b[0];
                    op_strid = b[1];
                }
                bool opid_bad = false;
                const int32_t opid = pack(op_ctr, op_strid, &opid_bad);
                if (opid_bad) bad = true;
                const int32_t prev_opid = ctx.prev_opid;
                const bool prev_opid_bad = ctx.prev_opid_bad;
                const bool had_prev = ctx.has_prev_op;
                ctx.prev_obj = obj;
                ctx.prev_obj_bad = obj_bad;
                ctx.prev_opid = opid;
                ctx.prev_opid_bad = opid_bad;
                ctx.has_prev_op = true;

                if (kind == 0) {  // insert
                    int32_t ref = 0;
                    if (of & kFRefPrev) {
                        if (!had_prev) return 1;
                        ref = prev_opid;
                        if (prev_opid_bad) bad = true;
                    } else if (!(of & kFRefHead)) {
                        const int32_t* b = take(2);
                        if (!b) return 1;
                        bool rb = false;
                        ref = pack(op_ctr + b[0], b[1], &rb);
                        if (rb) bad = true;
                    }
                    const int32_t* cch = take(1);
                    if (!cch) return 1;
                    const int64_t cp = static_cast<int64_t>(cch[0]) + 110;
                    if (cp < INT32_MIN || cp > INT32_MAX) return 1;
                    row[0] = 0; row[1] = obj; row[2] = opid; row[3] = ref;
                    row[4] = static_cast<int32_t>(cp);  // codec char bias
                    ++ci;
                } else if (kind == 1) {  // delete
                    const int32_t* b = take(2);
                    if (!b) return 1;
                    bool eb = false;
                    row[0] = 1; row[1] = obj; row[2] = opid;
                    row[3] = pack(op_ctr + b[0], b[1], &eb);
                    if (eb) bad = true;
                    ++cd;
                } else if (kind == 2 || kind == 3) {  // marks
                    const int32_t* pk = take(1);
                    if (!pk || pk[0] < 0 || (pk[0] >> 6)) return 1;
                    row[0] = 2; row[1] = obj; row[2] = opid;
                    row[3] = (kind == 2) ? 1 : 2;
                    row[4] = pk[0] & 3;       // mark type
                    row[5] = (pk[0] >> 2) & 3;  // start kind
                    row[7] = (pk[0] >> 4) & 3;  // end kind
                    int64_t base_ctr = op_ctr;
                    if (row[5] <= 1) {
                        const int32_t* b = take(2);
                        if (!b) return 1;
                        bool sb = false;
                        base_ctr += b[0];
                        row[6] = pack(base_ctr, b[1], &sb);
                        if (sb) bad = true;
                    }
                    if (row[7] <= 1) {
                        const int32_t* b = take(2);
                        if (!b) return 1;
                        bool ebb = false;
                        row[8] = pack(base_ctr + b[0], b[1], &ebb);
                        if (ebb) bad = true;
                    }
                    const int32_t* at = take(1);
                    if (!at) return 1;
                    if (at[0] < 0 || at[0] > n_strings) return 1;
                    row[9] = (at[0] == 0) ? 0 : str_base + at[0];
                    ++cm;
                } else if (kind == 5 && (of & kFRefHead)) {  // makeList
                    const int32_t* b = take(1);
                    if (!b) return 1;
                    if (b[0] < 0 || b[0] >= n_strings) return 1;
                    row[0] = kKindMakeList;
                    row[1] = obj; row[2] = opid;
                    row[3] = str_base + b[0];
                    // adopted (and counted) by the Python ingest layer,
                    // exactly like v1's JSON-spillover makeList
                } else if (kind == 5 || kind == 7) {  // makeMap / map del
                    const int32_t* b = take(1);
                    if (!b) return 1;
                    if (b[0] < 0 || b[0] >= n_strings) return 1;
                    row[0] = 6; row[1] = obj; row[2] = opid;
                    row[3] = str_base + b[0];
                    row[4] = (kind == 5) ? 6 : 0;  // VK_OBJ / VK_DELETED
                    row[5] = (kind == 5) ? row[2] : 0;
                    ++cp;
                } else if (kind == 6) {  // map set
                    const int32_t* b = take(3);
                    if (!b) return 1;
                    if (b[0] < 0 || b[0] >= n_strings) return 1;
                    if (b[1] < 1 || b[1] > 5) return 1;
                    if (b[1] == 1 && (b[2] < 0 || b[2] >= n_strings)) return 1;
                    row[0] = 6; row[1] = obj; row[2] = opid;
                    row[3] = str_base + b[0];
                    row[4] = b[1];
                    row[5] = (b[1] == 1) ? str_base + b[2] + 1 : b[2];
                    ++cp;
                } else {
                    return 1;  // unknown op kind
                }
            }
            if (bad) row[0] = 4;
            ++no;
        }
        o.ops_off[nc + 1] = static_cast<int32_t>(no);
        o.cnt_ins[nc] = ci;
        o.cnt_del[nc] = cd;
        o.cnt_mark[nc] = cm;
        o.cnt_map[nc] = cp;
        ++nc;
    }
    if (p != n_vals) return 1;
    return 0;
}
}  // namespace

extern "C" {

// Deterministic causal schedule.
//
//   n         : number of candidate changes
//   actor[i]  : actor index of change i (indices follow actor-string order)
//   seq[i]    : per-actor sequence number (1-based, contiguous per actor)
//   deps for change i live at dep_actor/dep_seq[dep_off[i] .. dep_off[i+1])
//   n_actors  : actor table size
//   base_clock: per-actor applied frontier (length n_actors)
//   out_order : caller-allocated, capacity n; receives scheduled change
//               indices in application order
//
// Returns the number scheduled; the remaining changes are causally stuck
// (their dependencies are not in the set).  Duplicates of one (actor, seq)
// and changes already below the clock are skipped (not scheduled, not stuck):
// mirrored from causal.py so the two implementations are interchangeable.
int32_t pt_causal_schedule(int32_t n, const int32_t* actor, const int32_t* seq,
                           const int32_t* dep_off, const int32_t* dep_actor,
                           const int32_t* dep_seq, int32_t n_actors,
                           const int32_t* base_clock, int32_t* out_order) {
    std::vector<int32_t> clock(base_clock, base_clock + n_actors);
    std::unordered_map<int64_t, int32_t> pending;  // (actor,seq) -> change idx
    pending.reserve(static_cast<size_t>(n) * 2);

    for (int32_t i = 0; i < n; ++i) {
        if (seq[i] <= clock[actor[i]]) continue;           // already applied
        pending.emplace(key_of(actor[i], seq[i]), i);      // first wins (dup skip)
    }

    auto admissible = [&](int32_t i) -> bool {
        if (seq[i] != clock[actor[i]] + 1) return false;
        for (int32_t d = dep_off[i]; d < dep_off[i + 1]; ++d) {
            if (clock[dep_actor[d]] < dep_seq[d]) return false;
        }
        return true;
    };

    // waiters: blocker (actor, seq) -> change indices waiting on it
    std::unordered_map<int64_t, std::vector<int32_t>> waiters;
    waiters.reserve(pending.size());
    for (const auto& [key, i] : pending) {
        if (seq[i] > 1 && clock[actor[i]] < seq[i] - 1) {
            waiters[key_of(actor[i], seq[i] - 1)].push_back(i);
        }
        for (int32_t d = dep_off[i]; d < dep_off[i + 1]; ++d) {
            if (dep_actor[d] != actor[i] && clock[dep_actor[d]] < dep_seq[d]) {
                waiters[key_of(dep_actor[d], dep_seq[d])].push_back(i);
            }
        }
    }

    // min-heap over (actor, seq): smallest ready first == Python determinism
    using HeapKey = std::pair<int64_t, int32_t>;  // (key, change idx)
    std::priority_queue<HeapKey, std::vector<HeapKey>, std::greater<HeapKey>> ready;
    for (const auto& [key, i] : pending) {
        if (admissible(i)) ready.emplace(key, i);
    }

    int32_t count = 0;
    while (!ready.empty()) {
        auto [key, i] = ready.top();
        ready.pop();
        auto it = pending.find(key);
        if (it == pending.end()) continue;  // woken more than once
        pending.erase(it);
        out_order[count++] = i;
        clock[actor[i]] = seq[i];
        auto w = waiters.find(key);
        if (w != waiters.end()) {
            for (int32_t j : w->second) {
                auto pj = pending.find(key_of(actor[j], seq[j]));
                if (pj != pending.end() && admissible(j)) {
                    ready.emplace(key_of(actor[j], seq[j]), j);
                }
            }
            waiters.erase(w);
        }
    }
    return count;
}

// Zigzag-varint encode int32 stream into out (capacity cap bytes).
// Returns bytes written, or -1 if cap is insufficient.
int64_t pt_varint_encode(const int32_t* in, int64_t n, uint8_t* out, int64_t cap) {
    int64_t pos = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t z = (static_cast<uint32_t>(in[i]) << 1) ^
                     static_cast<uint32_t>(in[i] >> 31);
        do {
            if (pos >= cap) return -1;
            uint8_t byte = z & 0x7F;
            z >>= 7;
            out[pos++] = byte | (z ? 0x80 : 0);
        } while (z);
    }
    return pos;
}

// Decode nbytes of zigzag-varint into out (capacity cap ints).
// Returns ints written, or -1 on malformed/overflowing input.
int64_t pt_varint_decode(const uint8_t* in, int64_t nbytes, int32_t* out,
                         int64_t cap) {
    int64_t pos = 0, count = 0;
    while (pos < nbytes) {
        uint32_t z = 0;
        int shift = 0;
        while (true) {
            if (pos >= nbytes || shift > 28) return -1;
            uint8_t byte = in[pos++];
            z |= static_cast<uint32_t>(byte & 0x7F) << shift;
            if (!(byte & 0x80)) break;
            shift += 7;
        }
        if (count >= cap) return -1;
        out[count++] = static_cast<int32_t>((z >> 1) ^ (~(z & 1) + 1));
    }
    return count;
}

// ---------------------------------------------------------------------------
// pt_parse_changes — the frame-native ingest fast path.
//
// Walks a binary change-frame's decoded int payload (the exact layout
// written by peritext_tpu_torch/parallel/codec.py::encode_frame) straight into
// (a) per-change metadata arrays and (b) a uniform 10-column op matrix in
// device-packed identifier form, skipping Python Change objects entirely.
// Everything downstream (causal budget, stream splitting, padding) is then
// vectorizable numpy on these arrays.
//
// Column layout of ops[row*10 + c] (kinds: 0 insert, 1 delete, 2 mark,
// 3 json-spillover, 4 unsupported/undeclared, 6 map-register op):
//   c0 kind
//   c1 obj id, packed (ctr << actor_bits | actor); -1 = ROOT, 0 = n/a
//   c2 op id, packed
//   c3 insert: ref elem packed (0 = HEAD) | delete: target elem packed
//      | mark: action (1 add, 2 remove)   | json: string-table index
//      | map: key string-table index
//   c4 insert: codepoint | mark: mark-type index
//      | map: register value kind (packed.VK_*: 0 del, 1 str, 2 int,
//        3 true, 4 false, 5 null, 6 child map)
//   c5 mark: start boundary kind (0 before, 1 after, 2 startOf, 3 endOf)
//      | map: payload (str: string-table index + 1; int: the value;
//        child map: its own packed op id)
//   c6 mark: start elem packed (0 = none)
//   c7 mark: end boundary kind
//   c8 mark: end elem packed
//   c9 mark: attr string-table index + 1 (0 = none)
//
// str2actor maps frame string-table indices to *declared* actor-table
// indices (-1 = string is not a declared actor): identifier packing must
// use the session's stable actor numbering, not frame-local order.
//
// Returns 0 on success; -1 malformed payload; -2 dep capacity; -3 op
// capacity.  A change whose actor is undeclared gets ch_actor[i] = -1 and
// all its ops marked kind 4 (the caller demotes the doc to the object
// path); an op with an undeclared actor or an over-wide counter is kind 4.
int32_t pt_parse_changes(
    const int32_t* vals, int64_t n_vals, int32_t n_changes,
    const int32_t* str2actor, int32_t n_strings,
    int32_t actor_bits, int32_t max_ctr, int32_t version,
    int32_t* ch_actor, int32_t* ch_seq,
    int32_t* dep_off, int32_t* dep_actor, int32_t* dep_seq, int64_t dep_cap,
    int32_t* ops_off, int32_t* ops, int64_t op_cap,
    int32_t* cnt_ins, int32_t* cnt_del, int32_t* cnt_mark, int32_t* cnt_map) {
    int64_t p = 0;       // cursor into vals
    int64_t nd = 0;      // deps written
    int64_t no = 0;      // op rows written
    dep_off[0] = 0;
    ops_off[0] = 0;
    if (version >= 2) {
        // declared-actor count: distinct positive ids in str2actor
        int32_t n_declared = 0;
        for (int32_t i = 0; i < n_strings; ++i) {
            if (str2actor[i] > 0) ++n_declared;
        }
        WireOut o{ch_actor, ch_seq, dep_off, dep_actor, dep_seq, dep_cap,
                  ops_off, ops, op_cap, cnt_ins, cnt_del, cnt_mark, cnt_map};
        int64_t nc = 0;
        const int32_t rc = walk_v2(vals, n_vals, n_changes, str2actor,
                                   n_strings, n_declared, actor_bits, max_ctr,
                                   0, o, nc, nd, no);
        return (rc == 1) ? -1 : rc;
    }

    auto take = [&](int64_t k) -> const int32_t* {
        if (p + k > n_vals) return nullptr;
        const int32_t* ptr = vals + p;
        p += k;
        return ptr;
    };
    auto actor_of = [&](int32_t strid) -> int32_t {
        if (strid < 0 || strid >= n_strings) return -2;  // malformed
        return str2actor[strid];
    };
    // pack an opid pair; returns 0 with *bad set when unsupported
    auto pack = [&](int32_t ctr, int32_t strid, bool* bad) -> int32_t {
        int32_t a = actor_of(strid);
        if (a == -2) { *bad = true; return 0; }
        if (a < 0 || ctr < 0 || ctr > max_ctr) { *bad = true; return 0; }
        return (ctr << actor_bits) | a;
    };

    for (int32_t c = 0; c < n_changes; ++c) {
        const int32_t* h = take(4);  // actor, seq, start_op, n_deps
        if (!h) return -1;
        int32_t a = actor_of(h[0]);
        if (a == -2) return -1;
        ch_actor[c] = a;  // may be -1: undeclared actor, caller demotes
        ch_seq[c] = h[1];
        int32_t ndeps = h[3];
        if (ndeps < 0) return -1;
        for (int32_t d = 0; d < ndeps; ++d) {
            const int32_t* dp = take(2);
            if (!dp) return -1;
            int32_t da = actor_of(dp[0]);
            if (da == -2) return -1;
            if (da < 0) { ch_actor[c] = -1; continue; }  // dep on undeclared
            if (nd >= dep_cap) return -2;
            dep_actor[nd] = da;
            dep_seq[nd] = dp[1];
            ++nd;
        }
        dep_off[c + 1] = static_cast<int32_t>(nd);

        const int32_t* nop = take(1);
        if (!nop) return -1;
        int32_t nops = nop[0];
        if (nops < 0) return -1;
        int32_t ci = 0, cd = 0, cm = 0, cp = 0;
        for (int32_t k = 0; k < nops; ++k) {
            if (no >= op_cap) return -3;
            int32_t* row = ops + no * 10;
            for (int i = 0; i < 10; ++i) row[i] = 0;
            const int32_t* kindp = take(1);
            if (!kindp) return -1;
            int32_t kind = *kindp;
            bool bad = (ch_actor[c] < 0);
            if (kind == 4) {  // JSON spillover: [strid]
                const int32_t* b = take(1);
                if (!b) return -1;
                if (b[0] < 0 || b[0] >= n_strings) return -1;
                row[0] = 3;
                row[3] = b[0];
            } else if (kind == 0) {  // insert: obj(3) opid(2) ref(3) char
                const int32_t* b = take(9);
                if (!b) return -1;
                row[0] = 0;
                row[1] = b[0] == 0 ? -1 : pack(b[1], b[2], &bad);
                row[2] = pack(b[3], b[4], &bad);
                row[3] = b[5] == 0 ? 0 : pack(b[6], b[7], &bad);
                row[4] = b[8];
                ++ci;
            } else if (kind == 1) {  // delete: obj(3) opid(2) elem(2)
                const int32_t* b = take(7);
                if (!b) return -1;
                row[0] = 1;
                row[1] = b[0] == 0 ? -1 : pack(b[1], b[2], &bad);
                row[2] = pack(b[3], b[4], &bad);
                row[3] = pack(b[5], b[6], &bad);
                ++cd;
            } else if (kind == 2 || kind == 3) {
                // mark: obj(3) opid(2) mtype s(3) e(3) attr
                const int32_t* b = take(13);
                if (!b) return -1;
                if (b[6] < 0 || b[6] > 3 || b[9] < 0 || b[9] > 3) return -1;
                row[0] = 2;
                row[1] = b[0] == 0 ? -1 : pack(b[1], b[2], &bad);
                row[2] = pack(b[3], b[4], &bad);
                row[3] = (kind == 2) ? 1 : 2;  // MA_ADD / MA_REMOVE
                row[4] = b[5];
                row[5] = b[6];
                row[6] = (b[6] <= 1) ? pack(b[7], b[8], &bad) : 0;
                row[7] = b[9];
                row[8] = (b[9] <= 1) ? pack(b[10], b[11], &bad) : 0;
                if (b[12] < 0 || b[12] > n_strings) return -1;
                row[9] = b[12];
                ++cm;
            } else if (kind == 5 || kind == 7) {  // makeMap / map del: obj(3) opid(2) key
                const int32_t* b = take(6);
                if (!b) return -1;
                if (b[5] < 0 || b[5] >= n_strings) return -1;
                row[0] = 6;
                row[1] = b[0] == 0 ? -1 : pack(b[1], b[2], &bad);
                row[2] = pack(b[3], b[4], &bad);
                row[3] = b[5];
                row[4] = (kind == 5) ? 6 : 0;  // VK_OBJ / VK_DELETED
                row[5] = (kind == 5) ? row[2] : 0;
                ++cp;
            } else if (kind == 6) {  // map set: obj(3) opid(2) key vkind payload
                const int32_t* b = take(8);
                if (!b) return -1;
                if (b[5] < 0 || b[5] >= n_strings) return -1;
                if (b[6] < 1 || b[6] > 5) return -1;  // VK_STR..VK_NULL
                if (b[6] == 1 && (b[7] < 0 || b[7] >= n_strings)) return -1;
                row[0] = 6;
                row[1] = b[0] == 0 ? -1 : pack(b[1], b[2], &bad);
                row[2] = pack(b[3], b[4], &bad);
                row[3] = b[5];
                row[4] = b[6];
                row[5] = (b[6] == 1) ? b[7] + 1 : b[7];  // str: strid + 1
                ++cp;
            } else {
                return -1;  // unknown op kind: frame is corrupt
            }
            if (bad) row[0] = 4;
            ++no;
        }
        ops_off[c + 1] = static_cast<int32_t>(no);
        cnt_ins[c] = ci;
        cnt_del[c] = cd;
        cnt_mark[c] = cm;
        cnt_map[c] = cp;
    }
    if (p != n_vals) return -1;  // trailing garbage
    return 0;
}

// ---------------------------------------------------------------------------
// pt_schedule_split_batch — one call schedules and splits EVERY frame-mode
// document's pending parsed changes for a round.
//
// Per doc d: admit the longest causally-valid prefix (vector-clock admission,
// same rules as pt_causal_schedule) whose op usage fits the static round
// widths (ki/kd/km), and scatter its ops into the doc's padded stream rows
// (row-major (D, K) arrays shared with the object path; doc_row[d] selects
// the row).  Clocks advance in place.  This replaces ~30 small numpy calls
// per doc per round with one native call per round (the host-side bottleneck
// at pod scale — SURVEY §5.8 / BASELINE config 5).
//
// Within-round application order may differ from the scalar path's; any
// causally-valid order converges to the same state (the RGA skip rule and
// the order-independent mark table), which the differential tests assert.
//
// admitted[c]: 1 = applied this round, 2 = stale duplicate (consumed),
// 0 = deferred (stuck or over budget).  status[d]: 0 = ok, 1 = demote the
// doc (op on a non-text object, or a change that can never fit the widths).
// Returns total changes admitted.
int32_t pt_schedule_split_batch(
    int32_t n_docs, int32_t n_actors,
    const int32_t* ch_off, const int32_t* doc_row, const int32_t* text_obj,
    const int32_t* ch_actor, const int32_t* ch_seq,
    const int32_t* dep_off, const int32_t* dep_actor, const int32_t* dep_seq,
    const int32_t* ops_off, const int32_t* ops,
    int32_t* clock,  // (n_docs, n_actors) row-major, in/out
    int32_t ki, int32_t kd, int32_t km, int32_t kp,
    int32_t* ins_ref, int32_t* ins_op, int32_t* ins_char,
    int32_t* del_target,
    int32_t* m_action, int32_t* m_type, int32_t* m_sk, int32_t* m_se,
    int32_t* m_ek, int32_t* m_ee, int32_t* m_op, int32_t* m_attr,
    int32_t* p_obj, int32_t* p_key, int32_t* p_op, int32_t* p_kind,
    int32_t* p_val,
    int32_t* n_ins, int32_t* n_del, int32_t* n_mark, int32_t* n_map,
    int32_t* n_admitted,
    uint8_t* admitted, uint8_t* status) {
    int32_t total_admitted = 0;
    std::vector<int32_t> order;
    std::vector<int32_t> clock_save(n_actors);

    for (int32_t d = 0; d < n_docs; ++d) {
        const int32_t lo = ch_off[d], hi = ch_off[d + 1];
        int32_t* dclock = clock + static_cast<int64_t>(d) * n_actors;
        std::memcpy(clock_save.data(), dclock, n_actors * sizeof(int32_t));
        const int32_t row = doc_row[d];
        int32_t* r_ins_ref = ins_ref + static_cast<int64_t>(row) * ki;
        int32_t* r_ins_op = ins_op + static_cast<int64_t>(row) * ki;
        int32_t* r_ins_char = ins_char + static_cast<int64_t>(row) * ki;
        int32_t* r_del = del_target + static_cast<int64_t>(row) * kd;
        int64_t mbase = static_cast<int64_t>(row) * km;
        int64_t pbase = static_cast<int64_t>(row) * kp;

        order.clear();
        for (int32_t c = lo; c < hi; ++c) order.push_back(c);
        std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
            if (ch_actor[a] != ch_actor[b]) return ch_actor[a] < ch_actor[b];
            if (ch_seq[a] != ch_seq[b]) return ch_seq[a] < ch_seq[b];
            return a < b;
        });

        int32_t ci = 0, cd = 0, cm = 0, cp = 0, nch = 0;
        bool demote = false, budget_closed = false, progress = true;
        while (progress && !demote) {
            progress = false;
            for (int32_t c : order) {
                if (admitted[c] || demote) continue;
                const int32_t a = ch_actor[c], s = ch_seq[c];
                if (s <= dclock[a]) { admitted[c] = 2; continue; }  // stale dup
                if (budget_closed || s != dclock[a] + 1) continue;
                bool ok = true;
                for (int32_t dd = dep_off[c]; dd < dep_off[c + 1]; ++dd) {
                    if (dclock[dep_actor[dd]] < dep_seq[dd]) { ok = false; break; }
                }
                if (!ok) continue;
                // count this change's streams
                int32_t wi = 0, wd = 0, wm = 0, wp = 0;
                for (int32_t o = ops_off[c]; o < ops_off[c + 1]; ++o) {
                    const int32_t k = ops[static_cast<int64_t>(o) * 10];
                    if (k == 0) ++wi;
                    else if (k == 1) ++wd;
                    else if (k == 2) ++wm;
                    else if (k == 6) ++wp;
                    else if (k != 5) { demote = true; break; }  // json/bad left over
                }
                if (demote) break;
                if (wi > ki || wd > kd || wm > km || wp > kp) {
                    demote = true; break;  // never fits
                }
                if (ci + wi > ki || cd + wd > kd || cm + wm > km || cp + wp > kp) {
                    budget_closed = true;  // prefix semantics: round is full
                    continue;
                }
                // validate + scatter the ops
                for (int32_t o = ops_off[c]; o < ops_off[c + 1] && !demote; ++o) {
                    const int32_t* r = ops + static_cast<int64_t>(o) * 10;
                    const int32_t k = r[0];
                    if (k == 5) continue;
                    if (k == 6) {
                        // map-register op: container must not be the text
                        // LIST (a malformed peer targeting it would diverge
                        // from the scalar oracle, which raises); other
                        // object-kind validation is the sender encoder's job
                        if (r[1] == text_obj[d] && text_obj[d] != 0) {
                            demote = true; break;
                        }
                        p_obj[pbase + cp] = r[1]; p_key[pbase + cp] = r[3];
                        p_op[pbase + cp] = r[2]; p_kind[pbase + cp] = r[4];
                        p_val[pbase + cp] = r[5];
                        ++cp;
                        continue;
                    }
                    if (r[1] != text_obj[d]) { demote = true; break; }
                    if (k == 0) {
                        r_ins_ref[ci] = r[3]; r_ins_op[ci] = r[2]; r_ins_char[ci] = r[4];
                        ++ci;
                    } else if (k == 1) {
                        r_del[cd] = r[3];
                        ++cd;
                    } else {
                        m_action[mbase + cm] = r[3]; m_type[mbase + cm] = r[4];
                        m_sk[mbase + cm] = r[5]; m_se[mbase + cm] = r[6];
                        m_ek[mbase + cm] = r[7]; m_ee[mbase + cm] = r[8];
                        m_op[mbase + cm] = r[2]; m_attr[mbase + cm] = r[9];
                        ++cm;
                    }
                }
                if (demote) break;
                dclock[a] = s;
                admitted[c] = 1;
                ++nch;
                progress = true;
            }
        }

        if (demote) {
            // discard this doc's round: zero rows, restore clock, flag it
            std::memcpy(dclock, clock_save.data(), n_actors * sizeof(int32_t));
            std::memset(r_ins_ref, 0, ki * sizeof(int32_t));
            std::memset(r_ins_op, 0, ki * sizeof(int32_t));
            std::memset(r_ins_char, 0, ki * sizeof(int32_t));
            std::memset(r_del, 0, kd * sizeof(int32_t));
            for (int32_t* col : {m_action, m_type, m_sk, m_se, m_ek, m_ee, m_op, m_attr})
                std::memset(col + mbase, 0, km * sizeof(int32_t));
            for (int32_t* col : {p_obj, p_key, p_op, p_kind, p_val})
                std::memset(col + pbase, 0, kp * sizeof(int32_t));
            for (int32_t c = lo; c < hi; ++c) admitted[c] = 0;
            n_ins[d] = n_del[d] = n_mark[d] = n_map[d] = n_admitted[d] = 0;
            status[d] = 1;
            continue;
        }
        n_ins[d] = ci; n_del[d] = cd; n_mark[d] = cm; n_map[d] = cp;
        n_admitted[d] = nch;
        status[d] = 0;
        total_admitted += nch;
    }
    return total_admitted;
}

// ---------------------------------------------------------------------------
// pt_parse_frames — bulk whole-frame ingest: N raw wire frames -> flat parsed
// arrays in ONE call.
//
// This is the pod-scale data-loader path (SURVEY §5.8, BASELINE config 5):
// per-frame Python — header/string-table walks, actor lookups, per-frame
// array allocation — dominates streaming ingest once thousands of docs ship
// frames every round, so the whole loop moves here.  The frame layout is
// exactly parallel/codec.py::encode_frame (29-byte header, zigzag-varint
// string lengths + UTF-8 bytes, zigzag-varint int payload); the per-change
// payload walk matches pt_parse_changes above, with string-table and
// dep/op offsets GLOBALIZED across frames (f_str_off / f_ch_off give each
// frame's slice).
//
// Outputs use the same conventions as pt_parse_changes; additionally:
//   f_status[f]  : 0 ok, 1 corrupt (that frame contributes nothing; its
//                  slice in f_ch_off/f_str_off is empty)
//   str_start/str_len : byte spans of every string-table entry, absolute
//                  into `data`, so Python can lazily decode only the strings
//                  it needs (mark attrs, JSON-spillover rows)
//   ops col 3 (json rows) and col 9 (mark attr + 1) hold GLOBAL string ids.
//
// Actor identity: actor_bytes/actor_off list the declared actor table's
// UTF-8 names in interner order (index i -> interner id i+1; id 0 is the
// reserved None slot, matching utils/interning.Interner).
//
// Returns 0 on success, negative on output-capacity overflow (a caller
// sizing bug: capacities derive exactly from the validated frame headers).
int32_t pt_parse_frames(
    const uint8_t* data, const int64_t* frame_off, int32_t n_frames,
    const uint8_t* actor_bytes, const int64_t* actor_off, int32_t n_actors,
    int32_t actor_bits, int32_t max_ctr,
    int32_t* f_status, int32_t* f_ch_off, int32_t* f_str_off,
    int64_t* str_start, int32_t* str_len, int64_t str_cap,
    int32_t* ch_actor, int32_t* ch_seq, int64_t ch_cap,
    int32_t* dep_off, int32_t* dep_actor, int32_t* dep_seq, int64_t dep_cap,
    int32_t* ops_off, int32_t* ops, int64_t op_cap,
    int32_t* cnt_ins, int32_t* cnt_del, int32_t* cnt_mark, int32_t* cnt_map) {
    std::unordered_map<std::string_view, int32_t> amap;
    amap.reserve(static_cast<size_t>(n_actors) * 2);
    for (int32_t i = 0; i < n_actors; ++i) {
        amap.emplace(
            std::string_view(reinterpret_cast<const char*>(actor_bytes) + actor_off[i],
                             static_cast<size_t>(actor_off[i + 1] - actor_off[i])),
            i + 1);
    }

    int64_t nc = 0, nd = 0, no = 0, ns = 0;  // global cursors
    dep_off[0] = 0;
    ops_off[0] = 0;
    f_ch_off[0] = 0;
    f_str_off[0] = 0;
    std::vector<int32_t> vals;  // reused per-frame payload scratch
    std::vector<int32_t> s2a;   // frame string idx -> actor interner id | -1

    for (int32_t f = 0; f < n_frames; ++f) {
        const int64_t lo = frame_off[f], hi = frame_off[f + 1];
        const int64_t save_nc = nc, save_nd = nd, save_no = no, save_ns = ns;
        bool corrupt = false;

        do {
            if (hi - lo < 29 || hi > frame_off[n_frames]) { corrupt = true; break; }
            // header: magic(4) ver(1) n_changes(u32) n_strings(u32)
            //         n_ints(u64) payload_len(u64)  — little-endian packed
            const int32_t version = data[lo + 4];
            if (std::memcmp(data + lo, "PTXF", 4) != 0 ||
                (version != 1 && version != 2)) {
                corrupt = true; break;
            }
            uint32_t h_changes, h_strings;
            uint64_t h_ints, h_payload;
            std::memcpy(&h_changes, data + lo + 5, 4);
            std::memcpy(&h_strings, data + lo + 9, 4);
            std::memcpy(&h_ints, data + lo + 13, 8);
            std::memcpy(&h_payload, data + lo + 21, 8);
            const uint64_t body = static_cast<uint64_t>(hi - lo - 29);
            // min ints/change: 5 for v1 headers, 2 for v2's delta-elided form
            const uint64_t min_change_ints = (version == 1) ? 5 : 2;
            if (h_payload > body || h_ints > h_payload || h_strings > body ||
                static_cast<uint64_t>(h_changes) * min_change_ints > h_ints) {
                corrupt = true; break;
            }
            if (nc + h_changes > ch_cap) return -2;
            if (ns + h_strings > str_cap) return -4;

            // string table: zigzag-varint length + UTF-8 bytes per entry
            int64_t pos = lo + 29;
            s2a.assign(h_strings, -1);
            for (uint32_t s = 0; s < h_strings && !corrupt; ++s) {
                uint32_t z = 0;
                int shift = 0;
                while (true) {
                    if (pos >= hi || shift > 28) { corrupt = true; break; }
                    const uint8_t byte = data[pos++];
                    z |= static_cast<uint32_t>(byte & 0x7F) << shift;
                    if (!(byte & 0x80)) break;
                    shift += 7;
                }
                if (corrupt) break;
                const int32_t length = static_cast<int32_t>((z >> 1) ^ (~(z & 1) + 1));
                if (length < 0 || pos + length > hi) { corrupt = true; break; }
                str_start[ns + s] = pos;
                str_len[ns + s] = length;
                auto it = amap.find(std::string_view(
                    reinterpret_cast<const char*>(data) + pos,
                    static_cast<size_t>(length)));
                s2a[s] = (it == amap.end()) ? -1 : it->second;
                pos += length;
            }
            if (corrupt) break;
            if (pos + static_cast<int64_t>(h_payload) > hi) { corrupt = true; break; }

            // payload: zigzag varints, exactly h_ints of them
            vals.assign(h_ints, 0);
            {
                int64_t p = pos, count = 0;
                const int64_t pend = pos + static_cast<int64_t>(h_payload);
                while (p < pend) {
                    uint32_t z = 0;
                    int shift = 0;
                    while (true) {
                        if (p >= pend || shift > 28) { corrupt = true; break; }
                        const uint8_t byte = data[p++];
                        z |= static_cast<uint32_t>(byte & 0x7F) << shift;
                        if (!(byte & 0x80)) break;
                        shift += 7;
                    }
                    if (corrupt) break;
                    if (count >= static_cast<int64_t>(h_ints)) { corrupt = true; break; }
                    vals[count++] = static_cast<int32_t>((z >> 1) ^ (~(z & 1) + 1));
                }
                if (!corrupt && count != static_cast<int64_t>(h_ints)) corrupt = true;
            }
            if (corrupt) break;

            if (version == 2) {
                WireOut o{ch_actor, ch_seq, dep_off, dep_actor, dep_seq,
                          dep_cap, ops_off, ops, op_cap,
                          cnt_ins, cnt_del, cnt_mark, cnt_map};
                const int32_t rc = walk_v2(
                    vals.data(), static_cast<int64_t>(h_ints),
                    static_cast<int32_t>(h_changes), s2a.data(),
                    static_cast<int32_t>(h_strings), n_actors, actor_bits,
                    max_ctr, static_cast<int32_t>(ns), o, nc, nd, no);
                if (rc == -2) return -2;
                if (rc == -3) return -3;
                if (rc != 0) { corrupt = true; break; }
                ns += h_strings;
                break;  // frame done (the do-while(false) exits)
            }

            // v1 change walk (the pt_parse_changes logic, offsets globalized)
            const int32_t n_strings_f = static_cast<int32_t>(h_strings);
            int64_t p = 0;
            const int64_t n_vals = static_cast<int64_t>(h_ints);
            auto take = [&](int64_t k) -> const int32_t* {
                if (p + k > n_vals) return nullptr;
                const int32_t* ptr = vals.data() + p;
                p += k;
                return ptr;
            };
            auto actor_of = [&](int32_t strid) -> int32_t {
                if (strid < 0 || strid >= n_strings_f) return -2;
                return s2a[strid];
            };
            auto pack = [&](int32_t ctr, int32_t strid, bool* bad) -> int32_t {
                const int32_t a = actor_of(strid);
                if (a == -2) { *bad = true; return 0; }
                if (a < 0 || ctr < 0 || ctr > max_ctr) { *bad = true; return 0; }
                return (ctr << actor_bits) | a;
            };

            for (uint32_t c = 0; c < h_changes && !corrupt; ++c) {
                const int32_t* h = take(4);
                if (!h) { corrupt = true; break; }
                const int32_t a = actor_of(h[0]);
                if (a == -2) { corrupt = true; break; }
                ch_actor[nc] = a;  // may be -1: undeclared, caller demotes
                ch_seq[nc] = h[1];
                const int32_t ndeps = h[3];
                if (ndeps < 0) { corrupt = true; break; }
                for (int32_t d = 0; d < ndeps; ++d) {
                    const int32_t* dp = take(2);
                    if (!dp) { corrupt = true; break; }
                    const int32_t da = actor_of(dp[0]);
                    if (da == -2) { corrupt = true; break; }
                    if (da < 0) { ch_actor[nc] = -1; continue; }
                    if (nd >= dep_cap) return -2;
                    dep_actor[nd] = da;
                    dep_seq[nd] = dp[1];
                    ++nd;
                }
                if (corrupt) break;
                dep_off[nc + 1] = static_cast<int32_t>(nd);

                const int32_t* nop = take(1);
                if (!nop) { corrupt = true; break; }
                const int32_t nops = *nop;
                if (nops < 0) { corrupt = true; break; }
                int32_t ci = 0, cd = 0, cm = 0, cp = 0;
                for (int32_t k = 0; k < nops && !corrupt; ++k) {
                    if (no >= op_cap) return -3;
                    int32_t* row = ops + no * 10;
                    for (int i = 0; i < 10; ++i) row[i] = 0;
                    const int32_t* kindp = take(1);
                    if (!kindp) { corrupt = true; break; }
                    const int32_t kind = *kindp;
                    bool bad = (ch_actor[nc] < 0);
                    if (kind == 4) {  // JSON spillover: [strid] -> global id
                        const int32_t* b = take(1);
                        if (!b) { corrupt = true; break; }
                        if (b[0] < 0 || b[0] >= n_strings_f) { corrupt = true; break; }
                        row[0] = 3;
                        row[3] = static_cast<int32_t>(ns) + b[0];
                    } else if (kind == 0) {  // insert
                        const int32_t* b = take(9);
                        if (!b) { corrupt = true; break; }
                        row[0] = 0;
                        row[1] = b[0] == 0 ? -1 : pack(b[1], b[2], &bad);
                        row[2] = pack(b[3], b[4], &bad);
                        row[3] = b[5] == 0 ? 0 : pack(b[6], b[7], &bad);
                        row[4] = b[8];
                        ++ci;
                    } else if (kind == 1) {  // delete
                        const int32_t* b = take(7);
                        if (!b) { corrupt = true; break; }
                        row[0] = 1;
                        row[1] = b[0] == 0 ? -1 : pack(b[1], b[2], &bad);
                        row[2] = pack(b[3], b[4], &bad);
                        row[3] = pack(b[5], b[6], &bad);
                        ++cd;
                    } else if (kind == 2 || kind == 3) {  // add/remove mark
                        const int32_t* b = take(13);
                        if (!b) { corrupt = true; break; }
                        if (b[6] < 0 || b[6] > 3 || b[9] < 0 || b[9] > 3) {
                            corrupt = true; break;
                        }
                        row[0] = 2;
                        row[1] = b[0] == 0 ? -1 : pack(b[1], b[2], &bad);
                        row[2] = pack(b[3], b[4], &bad);
                        row[3] = (kind == 2) ? 1 : 2;
                        row[4] = b[5];
                        row[5] = b[6];
                        row[6] = (b[6] <= 1) ? pack(b[7], b[8], &bad) : 0;
                        row[7] = b[9];
                        row[8] = (b[9] <= 1) ? pack(b[10], b[11], &bad) : 0;
                        if (b[12] < 0 || b[12] > n_strings_f) { corrupt = true; break; }
                        row[9] = b[12] == 0
                            ? 0
                            : static_cast<int32_t>(ns) + (b[12] - 1) + 1;
                        ++cm;
                    } else if (kind == 5 || kind == 7) {  // makeMap / map del
                        const int32_t* b = take(6);
                        if (!b) { corrupt = true; break; }
                        if (b[5] < 0 || b[5] >= n_strings_f) { corrupt = true; break; }
                        row[0] = 6;
                        row[1] = b[0] == 0 ? -1 : pack(b[1], b[2], &bad);
                        row[2] = pack(b[3], b[4], &bad);
                        row[3] = static_cast<int32_t>(ns) + b[5];
                        row[4] = (kind == 5) ? 6 : 0;  // VK_OBJ / VK_DELETED
                        row[5] = (kind == 5) ? row[2] : 0;
                        ++cp;
                    } else if (kind == 6) {  // map set
                        const int32_t* b = take(8);
                        if (!b) { corrupt = true; break; }
                        if (b[5] < 0 || b[5] >= n_strings_f) { corrupt = true; break; }
                        if (b[6] < 1 || b[6] > 5) { corrupt = true; break; }
                        if (b[6] == 1 && (b[7] < 0 || b[7] >= n_strings_f)) {
                            corrupt = true; break;
                        }
                        row[0] = 6;
                        row[1] = b[0] == 0 ? -1 : pack(b[1], b[2], &bad);
                        row[2] = pack(b[3], b[4], &bad);
                        row[3] = static_cast<int32_t>(ns) + b[5];
                        row[4] = b[6];
                        row[5] = (b[6] == 1)
                            ? static_cast<int32_t>(ns) + b[7] + 1
                            : b[7];
                        ++cp;
                    } else {
                        corrupt = true; break;
                    }
                    if (bad) row[0] = 4;
                    ++no;
                }
                if (corrupt) break;
                ops_off[nc + 1] = static_cast<int32_t>(no);
                cnt_ins[nc] = ci;
                cnt_del[nc] = cd;
                cnt_mark[nc] = cm;
                cnt_map[nc] = cp;
                ++nc;
            }
            if (!corrupt && p != n_vals) corrupt = true;  // trailing garbage
            if (!corrupt) ns += h_strings;
        } while (false);

        if (corrupt) {
            nc = save_nc; nd = save_nd; no = save_no; ns = save_ns;
            f_status[f] = 1;
        } else {
            f_status[f] = 0;
        }
        f_ch_off[f + 1] = static_cast<int32_t>(nc);
        f_str_off[f + 1] = static_cast<int32_t>(ns);
    }
    return 0;
}

// ---------------------------------------------------------------------------
// pt_scalar_apply — the single-core scalar BASELINE the device path is
// measured against (BASELINE config 1).
//
// An honest C++ re-expression of the reference's applyChange hot loop
// (src/micromerge.ts:892-1297) over the parsed op matrix: sequential RGA
// insert with the convergence skip and O(n) reference scans
// (:1187-1245, :1304), tombstone deletes (:1250-1277), mark ops paying the
// reference's per-op anchor walk (the gap walk scans the whole metadata,
// :1002-1138 — modeled here as the two anchor scans), and map-register LWW
// (:1151-1175).  No batching, no vectorization — one op at a time on one
// core, exactly what "single-thread native baseline" means.
//
// ops: (n_ops, 10) rows in causally-applied order (pt_parse_changes layout).
// out_text receives the visible codepoints (capacity out_cap); returns the
// number of ops applied, visible count via *out_visible, and an anchor
// checksum via *out_check (defeats dead-code elimination of the scans).
int64_t pt_scalar_apply(
    const int32_t* ops, int64_t n_ops,
    int32_t* out_text, int64_t out_cap,
    int64_t* out_visible, int64_t* out_check) {
    struct Elem { int32_t id; int32_t ch; bool deleted; };
    std::vector<Elem> elems;
    elems.reserve(4096);
    struct Reg { int32_t obj, key, op, kind, val; };
    std::vector<Reg> regs;
    int64_t applied = 0;
    int64_t check = 0;

    auto find = [&](int32_t id) -> int64_t {
        for (int64_t i = 0; i < static_cast<int64_t>(elems.size()); ++i) {
            if (elems[i].id == id) return i;
        }
        return -1;
    };

    for (int64_t o = 0; o < n_ops; ++o) {
        const int32_t* r = ops + o * 10;
        const int32_t k = r[0];
        if (k == 0) {  // insert after ref (0 = HEAD), RGA skip rule
            int64_t p = -1;
            if (r[3] != 0) {
                p = find(r[3]);
                if (p < 0) continue;  // malformed: skip (oracle would throw)
            }
            int64_t q = p + 1;
            while (q < static_cast<int64_t>(elems.size()) && elems[q].id > r[2]) ++q;
            elems.insert(elems.begin() + q, Elem{r[2], r[4], false});
        } else if (k == 1) {  // delete -> tombstone
            int64_t p = find(r[3]);
            if (p < 0) continue;
            elems[p].deleted = true;
        } else if (k == 2) {  // mark: the reference walks the metadata per op
            if (r[6] != 0) check += find(r[6]);
            if (r[8] != 0) check += find(r[8]);
        } else if (k == 6) {  // map register LWW
            bool found = false;
            for (auto& g : regs) {
                if (g.obj == r[1] && g.key == r[3]) {
                    if (r[2] > g.op) { g.op = r[2]; g.kind = r[4]; g.val = r[5]; }
                    found = true;
                    break;
                }
            }
            if (!found) regs.push_back(Reg{r[1], r[3], r[2], r[4], r[5]});
        } else {
            continue;  // JSON / SKIP rows
        }
        ++applied;
    }

    int64_t vis = 0;
    for (const auto& e : elems) {
        if (!e.deleted && vis < out_cap) out_text[vis++] = e.ch;
    }
    *out_visible = vis;
    *out_check = check;
    return applied;
}

}  // extern "C"
