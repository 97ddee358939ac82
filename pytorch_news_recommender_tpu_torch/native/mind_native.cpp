// Native (C++) fast path for MIND behaviors preprocessing.
//
// The reference's behaviors pipeline is a pure-Python per-row loop fanned out
// over a multiprocessing.Pool (the reference's MIND_2020/data_processor.py:
// 490-541) — minutes of pandas + pickle on MIND-large. This library parses
// behaviors.tsv and builds the negative-sampled train groups / ragged eval
// splits directly into flat arrays, bit-identical to the Python path in
// ../data/mind.py (same splitmix64 hash-shuffle spec), at C++ line-scan
// speed. Exposed through ctypes (see __init__.py) — no pybind11 dependency.
//
// Memory protocol: every build_* call mallocs its output arrays; the caller
// copies them into numpy and then calls mind_free() on each pointer.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

constexpr uint64_t SM64_GAMMA = 0x9E3779B97F4A7C15ULL;
constexpr uint64_t SM64_M1 = 0xBF58476D1CE4E5B9ULL;
constexpr uint64_t SM64_M2 = 0x94D049BB133111EBULL;

// Identical to data/mind.py::_splitmix64.
inline uint64_t splitmix64(uint64_t x) {
  uint64_t z = x + SM64_GAMMA;
  z = (z ^ (z >> 30)) * SM64_M1;
  z = (z ^ (z >> 27)) * SM64_M2;
  return z ^ (z >> 31);
}

// '\n'-joined id blob -> id -> 1-based index map (line i -> index i+1).
std::unordered_map<std::string, int32_t> parse_index_blob(const char* blob) {
  std::unordered_map<std::string, int32_t> out;
  if (!blob) return out;
  const char* p = blob;
  int32_t idx = 1;
  while (*p) {
    const char* e = strchr(p, '\n');
    size_t len = e ? static_cast<size_t>(e - p) : strlen(p);
    if (len) out.emplace(std::string(p, len), idx++);
    if (!e) break;
    p = e + 1;
  }
  return out;
}

std::vector<std::string_view> split(std::string_view s, char sep) {
  std::vector<std::string_view> out;
  size_t start = 0;
  while (start <= s.size()) {
    size_t e = s.find(sep, start);
    if (e == std::string_view::npos) {
      out.push_back(s.substr(start));
      break;
    }
    out.push_back(s.substr(start, e - start));
    start = e + 1;
  }
  return out;
}

struct Row {
  std::string_view impression_id, user_id, time, history, impressions;
};

bool parse_row(std::string_view line, Row* row) {
  auto f = split(line, '\t');
  if (f.size() < 5) return false;
  row->impression_id = f[0];
  row->user_id = f[1];
  row->time = f[2];
  row->history = f[3];
  row->impressions = f[4];
  return true;
}

int32_t lookup(const std::unordered_map<std::string, int32_t>& m,
               std::string_view key) {
  auto it = m.find(std::string(key));
  return it == m.end() ? 0 : it->second;
}

// last `history_len` known clicks (data/mind.py::_split_history)
std::vector<int32_t> split_history(
    std::string_view blob,
    const std::unordered_map<std::string, int32_t>& news, int history_len) {
  std::vector<int32_t> clicks;
  for (auto tok : split(blob, ' ')) {
    if (tok.empty()) continue;
    int32_t idx = lookup(news, tok);
    if (idx) clicks.push_back(idx);
  }
  if (static_cast<int>(clicks.size()) > history_len)
    clicks.erase(clicks.begin(), clicks.end() - history_len);
  return clicks;
}

template <typename T>
T* copy_out(const std::vector<T>& v) {
  T* p = static_cast<T*>(malloc(v.size() * sizeof(T)));
  if (p && !v.empty()) memcpy(p, v.data(), v.size() * sizeof(T));
  return p;
}

}  // namespace

extern "C" {

void mind_free(void* p) { free(p); }

// Negative-sampled train groups; mirrors data/mind.py::build_train_samples.
// Outputs: browsed [n, H], cand [n, 1+K], user [n]. Returns n (or -1 on IO
// error).
int64_t mind_build_train(
    const char* behaviors_path, const char* news_blob, const char* user_blob,
    int32_t history_len, int32_t sample_size, int32_t min_history,
    uint64_t seed, int32_t** browsed_out, int32_t** cand_out,
    int32_t** user_out) {
  auto news = parse_index_blob(news_blob);
  auto users = parse_index_blob(user_blob);
  std::ifstream f(behaviors_path);
  if (!f.is_open()) return -1;

  const int H = history_len, K = sample_size;
  std::vector<int32_t> browsed, cand, user_ids;
  std::string line;
  int64_t row_no = -1;
  std::vector<int32_t> pos, neg;
  std::vector<std::pair<uint64_t, int32_t>> keyed;
  while (std::getline(f, line)) {
    ++row_no;
    if (!line.empty() && line.back() == '\r') line.pop_back();
    Row row;
    if (!parse_row(line, &row)) continue;
    if (row.history.empty() || row.impressions.empty()) continue;
    auto hist = split_history(row.history, news, H);
    if (static_cast<int>(hist.size()) < min_history) continue;
    int32_t uid = lookup(users, row.user_id);

    pos.clear();
    neg.clear();
    for (auto tok : split(row.impressions, ' ')) {
      if (tok.empty()) continue;
      size_t dash = tok.rfind('-');
      if (dash == std::string_view::npos) continue;
      int32_t idx = lookup(news, tok.substr(0, dash));
      if (!idx) continue;
      if (tok.substr(dash + 1) == "1") pos.push_back(idx);
      else neg.push_back(idx);
    }
    if (pos.empty()) continue;

    // hash-shuffle negatives (same spec as shuffle_negatives in mind.py)
    if (neg.size() > 1) {
      keyed.clear();
      uint64_t row_h = splitmix64(static_cast<uint64_t>(row_no));
      for (int32_t n : neg)
        keyed.emplace_back(
            splitmix64(seed ^ row_h ^ splitmix64(static_cast<uint64_t>(n))),
            n);
      std::stable_sort(keyed.begin(), keyed.end(),
                       [](const auto& a, const auto& b) {
                         return a.first < b.first;
                       });
      for (size_t i = 0; i < neg.size(); ++i) neg[i] = keyed[i].second;
    }

    std::vector<int32_t> browsed_row(H, 0);
    for (size_t i = 0; i < hist.size(); ++i)
      browsed_row[H - hist.size() + i] = hist[i];
    for (size_t i = 0; i < pos.size(); ++i) {
      browsed.insert(browsed.end(), browsed_row.begin(), browsed_row.end());
      cand.push_back(pos[i]);
      for (int j = 0; j < K; ++j) {
        size_t k = i * K + j;
        cand.push_back(k < neg.size() ? neg[k] : 0);
      }
      user_ids.push_back(uid);
    }
  }
  *browsed_out = copy_out(browsed);
  *cand_out = copy_out(cand);
  *user_out = copy_out(user_ids);
  return static_cast<int64_t>(user_ids.size());
}

// Ragged eval split; mirrors data/mind.py::build_eval_split.
// Outputs: browsed [m, H], user [m], keys [m], offsets [m+1], cand_flat,
// label_flat. Returns m (or -1 on IO error). *flat_len_out = total
// candidates.
int64_t mind_build_eval(
    const char* behaviors_path, const char* news_blob, const char* user_blob,
    int32_t history_len, int32_t with_labels,
    int32_t** browsed_out, int32_t** user_out, int64_t** keys_out,
    int64_t** offsets_out, int32_t** cand_flat_out, int8_t** label_flat_out,
    int64_t* flat_len_out) {
  auto news = parse_index_blob(news_blob);
  auto users = parse_index_blob(user_blob);
  std::ifstream f(behaviors_path);
  if (!f.is_open()) return -1;

  const int H = history_len;
  std::vector<int32_t> browsed, user_ids, cand_flat;
  std::vector<int64_t> keys, offsets{0};
  std::vector<int8_t> label_flat;
  std::string line;
  int64_t m = 0;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    Row row;
    if (!parse_row(line, &row)) continue;
    auto hist = split_history(row.history, news, H);

    int64_t count = 0;
    for (auto tok : split(row.impressions, ' ')) {
      if (tok.empty()) continue;
      std::string_view nid = tok;
      int8_t label = 0;
      if (with_labels) {
        size_t dash = tok.rfind('-');
        if (dash != std::string_view::npos) {
          nid = tok.substr(0, dash);
          label = tok.substr(dash + 1) == "1" ? 1 : 0;
        }
      }
      cand_flat.push_back(lookup(news, nid));
      label_flat.push_back(label);
      ++count;
    }
    if (!count) continue;

    std::vector<int32_t> browsed_row(H, 0);
    for (size_t i = 0; i < hist.size(); ++i)
      browsed_row[H - hist.size() + i] = hist[i];
    browsed.insert(browsed.end(), browsed_row.begin(), browsed_row.end());
    user_ids.push_back(lookup(users, row.user_id));

    // numeric impression id when parsable, else running 1-based counter
    bool digits = !row.impression_id.empty();
    for (char c : row.impression_id)
      if (c < '0' || c > '9') { digits = false; break; }
    keys.push_back(digits ? strtoll(std::string(row.impression_id).c_str(),
                                    nullptr, 10)
                          : m + 1);
    offsets.push_back(static_cast<int64_t>(cand_flat.size()));
    ++m;
  }
  *browsed_out = copy_out(browsed);
  *user_out = copy_out(user_ids);
  *keys_out = copy_out(keys);
  *offsets_out = copy_out(offsets);
  *cand_flat_out = copy_out(cand_flat);
  *label_flat_out = copy_out(label_flat);
  *flat_len_out = static_cast<int64_t>(cand_flat.size());
  return m;
}

// ---- runtime batcher ----
//
// Per-batch news deduplication for the training hot path (the runtime
// counterpart of data/loader.py::dedup_batch, whose np.unique costs ~2 ms
// per 512-impression batch). Output contract is bit-identical to
// np.unique(concat([0], browsed, cand), return_inverse=True):
// unique_out[:u] ascending (always containing the pad id 0) and inverse
// indices as ranks into it. Caller allocates every buffer.
//
// Returns u (distinct id count) or -1 when cap < u.
int64_t mind_batch_dedup(const int32_t* browsed, int64_t nb,
                         const int32_t* cand, int64_t nc,
                         int32_t* unique_out, int64_t cap,
                         int32_t* browsed_idx_out, int32_t* cand_idx_out) {
  // News ids are small dense corpus indices, so a direct-address stamp
  // table beats hashing AND yields ascending uniques for free (the scan
  // over [0, max_id] replaces the sort). An epoch stamp avoids clearing the
  // table between calls; buffers are thread_local so a warm call does zero
  // heap traffic.
  static thread_local std::vector<int32_t> stamp;  // id -> last epoch seen
  static thread_local std::vector<int32_t> rank;   // id -> sorted rank
  static thread_local int32_t epoch = 0;

  int32_t max_id = 0;
  for (int64_t i = 0; i < nb; ++i)
    if (browsed[i] > max_id) max_id = browsed[i];
  for (int64_t i = 0; i < nc; ++i)
    if (cand[i] > max_id) max_id = cand[i];
  if (static_cast<int64_t>(stamp.size()) <= max_id) {
    stamp.assign(static_cast<size_t>(max_id) + 1, epoch);  // all "old"
    rank.resize(static_cast<size_t>(max_id) + 1);
    epoch += 1;
  }
  const int32_t ep = epoch++;

  stamp[0] = ep;  // pad id is always present
  for (int64_t i = 0; i < nb; ++i) stamp[browsed[i]] = ep;
  for (int64_t i = 0; i < nc; ++i) stamp[cand[i]] = ep;

  int64_t u = 0;
  for (int32_t id = 0; id <= max_id; ++id) {
    if (stamp[id] == ep) {
      if (u >= cap) return -1;
      unique_out[u] = id;
      rank[id] = static_cast<int32_t>(u);
      ++u;
    }
  }
  for (int64_t i = u; i < cap; ++i) unique_out[i] = 0;
  for (int64_t i = 0; i < nb; ++i) browsed_idx_out[i] = rank[browsed[i]];
  for (int64_t i = 0; i < nc; ++i) cand_idx_out[i] = rank[cand[i]];
  return u;
}

// ---- tokenizer fast path ----
//
// Word-id conversion for the news table (the per-news Python loop in
// data/mind.py::build_dataset — reference semantics at
// the reference's MIND_2020/data_processor.py:151-219: lowercase, DELETE
// digit characters, \w+ tokens, keep in-vocab words, truncate+pad).
//
// ASCII-exact contract: for pure-ASCII text, Python's str.lower() is
// tolower, digit deletion is byte deletion, and regex \w is [a-zA-Z0-9_]
// (digits already deleted, and deletion does NOT break a token: "ab1cd"
// tokenizes as "abcd" on both paths). Any text containing a byte >= 0x80
// is NOT processed here — its row index is flagged in fallback_out and the
// Python caller redoes it with the reference-exact unicode path, so the
// combined result is bit-identical by construction.
//
// texts_blob: '\n'-joined texts (one per row; '\n' and ' ' are both
// non-word separators so the join character is semantically neutral).
// vocab_blob: '\n'-joined words, line i -> word id i+1 (see
// __init__.py::_index_blob). ids_out: [n_texts, length] int32, 0-padded.
// fallback_out: [n_texts] uint8, 1 = redo this row in Python.
// Returns n_texts, or -1 on bad arguments.
int64_t mind_tokenize_ids(const char* texts_blob, int64_t n_texts,
                          const char* vocab_blob, int32_t length,
                          int32_t* ids_out, uint8_t* fallback_out) {
  if (!texts_blob || !vocab_blob || length <= 0 || !ids_out || !fallback_out)
    return -1;
  auto vocab = parse_index_blob(vocab_blob);
  const char* p = texts_blob;
  std::string token;
  token.reserve(64);
  for (int64_t row = 0; row < n_texts; ++row) {
    const char* e = strchr(p, '\n');
    std::string_view text(p, e ? static_cast<size_t>(e - p) : strlen(p));
    int32_t* out = ids_out + row * length;
    for (int32_t j = 0; j < length; ++j) out[j] = 0;
    fallback_out[row] = 0;

    bool ascii = true;
    for (unsigned char c : text)
      if (c >= 0x80) { ascii = false; break; }
    if (!ascii) {
      fallback_out[row] = 1;
    } else {
      int32_t n_ids = 0;
      token.clear();
      auto flush = [&]() {
        if (!token.empty() && n_ids < length) {
          auto it = vocab.find(token);
          if (it != vocab.end()) out[n_ids++] = it->second;
        }
        token.clear();
      };
      for (unsigned char c : text) {
        if (c >= '0' && c <= '9') continue;  // deleted, does not break token
        unsigned char lc =
            (c >= 'A' && c <= 'Z') ? static_cast<unsigned char>(c + 32) : c;
        bool word = (lc >= 'a' && lc <= 'z') || lc == '_';
        if (word) {
          token.push_back(static_cast<char>(lc));
        } else {
          flush();
          // early exit once the row is full: remaining tokens are
          // truncated on the Python path too
          if (n_ids >= length) break;
        }
      }
      flush();
    }
    if (!e) {
      // blob ended early: remaining rows (if any) fall back
      for (int64_t r = row + 1; r < n_texts; ++r) {
        fallback_out[r] = 1;
        for (int32_t j = 0; j < length; ++j) ids_out[r * length + j] = 0;
      }
      return n_texts;
    }
    p = e + 1;
  }
  return n_texts;
}

}  // extern "C"
