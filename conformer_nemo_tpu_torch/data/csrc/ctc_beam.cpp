// CTC prefix beam search with ARPA n-gram LM fusion (host-side, C++).
//
// Behavioral parity target: the reference's external `ctc_decoders` package —
// Baidu DeepSpeech-style prefix beam search with a KenLM word n-gram scorer
// (NeMo's `nemo/collections/asr/modules/beam_search_decoder.py:21-103`:
// Scorer(alpha, beta, lm_path, vocab), beam over character posteriors, word-
// boundary LM scoring with insertion bonus).
//
// This implementation is written from the published algorithm (Hannun et al.
// 2014 prefix beam search; Katz-backoff ARPA scoring) — no code is taken from
// ctc_decoders/KenLM. LM backends: ARPA text (+ our .binlm cache) and, via
// explicit opt-in, KenLM binaries of the probing (kenlm_probing.h) and
// full trie (kenlm_trie.h: trie/quant_trie/array_trie/quant_array_trie)
// families; rest_probing keeps the actionable rejection.
//
// Exposed via a C ABI for ctypes (no pybind11). The JAX package builds the
// same source from its own tree; the two copies are kept identical in
// behaviour, so an `.binlm` cache written by either loads in the other.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <limits>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

#include "kenlm_probing.h"
#include "kenlm_trie.h"

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double log_sum_exp(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = std::max(a, b);
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

// Word n-gram scorer interface consumed by the beam search: map word
// strings to backend-internal ids, then score log10 P(w | context).
class LmBase {
 public:
  virtual ~LmBase() = default;
  virtual uint32_t LookupId(const std::string& w) const = 0;
  virtual double Score(const std::vector<uint32_t>& context,
                       uint32_t w) const = 0;
};

// ---------------------------------------------------------------------------
// ARPA n-gram language model with Katz backoff. Probabilities kept in log10
// (ARPA native); conversion to natural log happens at the scoring boundary.
// ---------------------------------------------------------------------------

class ArpaLM : public LmBase {
 public:
  bool Load(const std::string& path) {
    if (IsBinary(path)) return LoadBinary(path);
    std::ifstream in(path);
    if (!in) return false;
    std::string line;
    int cur_order = 0;
    bool in_grams = false;
    while (std::getline(in, line)) {
      // strip \r
      if (!line.empty() && line.back() == '\r') line.pop_back();
      if (line.empty()) continue;
      if (line[0] == '\\') {
        if (line.rfind("\\data\\", 0) == 0) { in_grams = false; continue; }
        size_t dash = line.find("-grams:");
        if (dash != std::string::npos) {
          cur_order = std::stoi(line.substr(1, dash - 1));
          max_order_ = std::max(max_order_, cur_order);
          in_grams = true;
          continue;
        }
        if (line.rfind("\\end\\", 0) == 0) break;
        continue;
      }
      if (!in_grams || cur_order == 0) continue;
      // "logprob<TAB>w1 w2 ... wN[<TAB>backoff]"
      std::istringstream ss(line);
      double logp;
      if (!(ss >> logp)) continue;
      std::vector<uint32_t> ids;
      ids.reserve(cur_order);
      std::string word;
      for (int i = 0; i < cur_order; ++i) {
        if (!(ss >> word)) break;
        ids.push_back(WordId(word));
      }
      if ((int)ids.size() != cur_order) continue;
      double backoff = 0.0;
      bool has_backoff = static_cast<bool>(ss >> backoff);
      uint64_t key = Hash(ids.data(), ids.size());
      probs_[key] = logp;
      if (has_backoff) backoffs_[key] = backoff;
    }
    return max_order_ > 0;
  }

  uint32_t WordId(const std::string& w) {
    auto it = vocab_.find(w);
    if (it != vocab_.end()) return it->second;
    uint32_t id = static_cast<uint32_t>(vocab_.size()) + 1;  // 0 reserved
    vocab_.emplace(w, id);
    return id;
  }

  // id for scoring only: unknown words map to <unk> if present, else 0.
  uint32_t LookupId(const std::string& w) const override {
    auto it = vocab_.find(w);
    if (it != vocab_.end()) return it->second;
    auto unk = vocab_.find("<unk>");
    return unk != vocab_.end() ? unk->second : 0;
  }

  // log10 P(w | context) with Katz backoff. context = previous words,
  // truncated to max_order-1.
  double Score(const std::vector<uint32_t>& context, uint32_t w) const override {
    int max_ctx = max_order_ - 1;
    int start = std::max(0, (int)context.size() - max_ctx);
    return ScoreBackoff(context, start, w);
  }

  int max_order() const { return max_order_; }
  bool has_word(const std::string& w) const { return vocab_.count(w) > 0; }

  // ---- binary cache (our own flat format; NOT KenLM .bin) ---------------
  // Large ARPA text parses are slow to load at serving startup; the cache
  // round-trips the fully-parsed tables. Layout: magic "CNLM0001", then
  // max_order, vocab (len,bytes,id)*, probs (hash,logp)*, backoffs.
  static bool IsBinary(const std::string& path) {
    std::ifstream in(path, std::ios::binary);
    char m[8] = {0};
    in.read(m, 8);
    return in.gcount() == 8 && std::memcmp(m, "CNLM0001", 8) == 0;
  }

  bool SaveBinary(const std::string& path) const {
    // write-then-rename: a crash mid-write must not leave a truncated file
    // with a valid magic at the final path (it would shadow the ARPA).
    const std::string tmp = path + ".tmp";
    {
      std::ofstream out(tmp, std::ios::binary | std::ios::trunc);
      if (!out) return false;
      out.write("CNLM0001", 8);
      auto w64 = [&](uint64_t v) { out.write(reinterpret_cast<char*>(&v), 8); };
      auto wd = [&](double v) { out.write(reinterpret_cast<char*>(&v), 8); };
      w64(static_cast<uint64_t>(max_order_));
      w64(vocab_.size());
      for (const auto& kv : vocab_) {
        w64(kv.first.size());
        out.write(kv.first.data(), static_cast<std::streamsize>(kv.first.size()));
        w64(kv.second);
      }
      w64(probs_.size());
      for (const auto& kv : probs_) { w64(kv.first); wd(kv.second); }
      w64(backoffs_.size());
      for (const auto& kv : backoffs_) { w64(kv.first); wd(kv.second); }
      if (!out) { std::remove(tmp.c_str()); return false; }
    }
    if (std::rename(tmp.c_str(), path.c_str()) != 0) {
      std::remove(tmp.c_str());
      return false;
    }
    return true;
  }

  bool LoadBinary(const std::string& path) {
    std::ifstream in(path, std::ios::binary | std::ios::ate);
    if (!in) return false;
    const uint64_t file_size = static_cast<uint64_t>(in.tellg());
    in.seekg(0);
    char m[8];
    in.read(m, 8);
    if (in.gcount() != 8 || std::memcmp(m, "CNLM0001", 8) != 0) return false;
    bool bad = false;
    auto r64 = [&]() {
      uint64_t v = 0;
      in.read(reinterpret_cast<char*>(&v), 8);
      if (in.gcount() != 8) bad = true;
      return v;
    };
    auto rd = [&]() {
      double v = 0;
      in.read(reinterpret_cast<char*>(&v), 8);
      if (in.gcount() != 8) bad = true;
      return v;
    };
    // every count/length is bounded by the file size: a truncated or
    // corrupted cache must fail cleanly, not throw bad_alloc through the
    // extern "C" boundary.
    auto plausible = [&](uint64_t n, uint64_t unit) {
      return !bad && n <= file_size / (unit ? unit : 1);
    };
    max_order_ = static_cast<int>(r64());
    uint64_t nv = r64();
    if (!plausible(nv, 16)) return false;
    vocab_.clear();
    vocab_.reserve(nv);
    std::string word;
    for (uint64_t i = 0; i < nv; ++i) {
      uint64_t len = r64();
      if (!plausible(len, 1)) return false;
      word.resize(len);
      in.read(&word[0], static_cast<std::streamsize>(len));
      if (static_cast<uint64_t>(in.gcount()) != len) return false;
      uint64_t id = r64();
      vocab_.emplace(word, static_cast<uint32_t>(id));
    }
    uint64_t np = r64();
    if (!plausible(np, 16)) return false;
    probs_.clear();
    probs_.reserve(np);
    for (uint64_t i = 0; i < np; ++i) {
      uint64_t k = r64();
      probs_.emplace(k, rd());
    }
    uint64_t nb = r64();
    if (!plausible(nb, 16)) return false;
    backoffs_.clear();
    backoffs_.reserve(nb);
    for (uint64_t i = 0; i < nb; ++i) {
      uint64_t k = r64();
      backoffs_.emplace(k, rd());
    }
    return !bad && static_cast<bool>(in) && max_order_ > 0;
  }

 private:
  double ScoreBackoff(const std::vector<uint32_t>& ctx, int start, uint32_t w) const {
    // try longest n-gram (ctx[start..]) + w, recurse with shorter context.
    std::vector<uint32_t> ng(ctx.begin() + start, ctx.end());
    ng.push_back(w);
    auto it = probs_.find(Hash(ng.data(), ng.size()));
    if (it != probs_.end()) return it->second;
    if (ng.size() == 1) {
      // unseen unigram: hard floor
      return -7.0;
    }
    // backoff weight of the context itself
    double bo = 0.0;
    std::vector<uint32_t> c(ctx.begin() + start, ctx.end());
    auto bit = backoffs_.find(Hash(c.data(), c.size()));
    if (bit != backoffs_.end()) bo = bit->second;
    return bo + ScoreBackoff(ctx, start + 1, w);
  }

  static uint64_t Hash(const uint32_t* ids, size_t n) {
    uint64_t h = 1469598103934665603ull;
    for (size_t i = 0; i < n; ++i) {
      h ^= ids[i];
      h *= 1099511628211ull;
    }
    return h ^ (n << 56);
  }

  std::unordered_map<std::string, uint32_t> vocab_;
  std::unordered_map<uint64_t, double> probs_;
  std::unordered_map<uint64_t, double> backoffs_;
  int max_order_ = 0;
};

// KenLM probing-binary backend (mmap scorer; see kenlm_probing.h).
class KenlmProbingLM : public LmBase {
 public:
  bool Load(const std::string& path, std::string* err) {
    return model_.Load(path, err);
  }
  uint32_t LookupId(const std::string& w) const override {
    return model_.WordId(w);
  }
  double Score(const std::vector<uint32_t>& ctx, uint32_t w) const override {
    return model_.Score(ctx, w);
  }
  const kenlm_probing::Model& model() const { return model_; }

 private:
  kenlm_probing::Model model_;
};

// KenLM trie / quant_trie backend (mmap scorer; see kenlm_trie.h).
class KenlmTrieLM : public LmBase {
 public:
  bool Load(const std::string& path, std::string* err) {
    return model_.Load(path, err);
  }
  uint32_t LookupId(const std::string& w) const override {
    return model_.WordId(w);
  }
  double Score(const std::vector<uint32_t>& ctx, uint32_t w) const override {
    return model_.Score(ctx, w);
  }
  const kenlm_trie::Model& model() const { return model_; }

 private:
  kenlm_trie::Model model_;
};

// ---------------------------------------------------------------------------
// Prefix beam search (Hannun et al. 2014) over char posteriors with optional
// word-boundary LM fusion: at each completed word, add
// alpha * ln(10) * log10 P_lm(word | history) + beta.
// ---------------------------------------------------------------------------

struct Prefix {
  std::vector<int> chars;       // label ids (no blanks, collapsed)
  double p_b = kNegInf;         // prob ending in blank
  double p_nb = kNegInf;        // prob ending in non-blank
  double lm_score = 0.0;        // accumulated LM fusion score (natural log)

  double total() const { return log_sum_exp(p_b, p_nb) + lm_score; }
};

struct PrefixHash {
  size_t operator()(const std::vector<int>& v) const {
    size_t h = 1469598103934665603ull;
    for (int x : v) { h ^= (size_t)x; h *= 1099511628211ull; }
    return h;
  }
};

class BeamSearcher {
 public:
  BeamSearcher(std::vector<std::string> vocab, int blank_id, int beam_width,
               double alpha, double beta, const LmBase* lm, int space_id)
      : vocab_(std::move(vocab)), blank_(blank_id), beam_(beam_width),
        alpha_(alpha), beta_(beta), lm_(lm), space_(space_id) {}

  // log_probs: [T, V] row-major natural-log posteriors.
  std::vector<std::pair<std::string, double>> Search(const float* log_probs, int T,
                                                     int V, int nbest) {
    std::unordered_map<std::vector<int>, Prefix, PrefixHash> beam;
    Prefix root;
    root.p_b = 0.0;
    beam.emplace(std::vector<int>{}, root);

    for (int t = 0; t < T; ++t) {
      const float* row = log_probs + (size_t)t * V;
      std::unordered_map<std::vector<int>, Prefix, PrefixHash> next;
      // prune chars: keep those above a threshold relative to max
      double row_max = kNegInf;
      for (int v = 0; v < V; ++v) row_max = std::max(row_max, (double)row[v]);
      const double cutoff = row_max - 10.0;

      for (auto& kv : beam) {
        const std::vector<int>& prefix = kv.first;
        const Prefix& p = kv.second;
        int last = prefix.empty() ? -1 : prefix.back();

        // blank extension
        double pb = (double)row[blank_] + log_sum_exp(p.p_b, p.p_nb);
        Upsert(next, prefix, /*is_blank=*/true, pb, p.lm_score);

        for (int v = 0; v < V; ++v) {
          if (v == blank_ || (double)row[v] < cutoff) continue;
          double pv = (double)row[v];
          if (v == last) {
            // repeat char: extends p_nb on same prefix; new char needs blank
            Upsert(next, prefix, false, pv + p.p_nb, p.lm_score);
            std::vector<int> np = prefix;
            np.push_back(v);
            double base = pv + p.p_b;
            Upsert(next, np, false, base, LmExtend(p, np));
          } else {
            std::vector<int> np = prefix;
            np.push_back(v);
            double base = pv + log_sum_exp(p.p_b, p.p_nb);
            Upsert(next, np, false, base, LmExtend(p, np));
          }
        }
      }
      // prune to beam width by total score
      std::vector<std::pair<double, const std::vector<int>*>> order;
      order.reserve(next.size());
      for (auto& kv : next) order.emplace_back(kv.second.total(), &kv.first);
      std::sort(order.begin(), order.end(),
                [](auto& a, auto& b) { return a.first > b.first; });
      std::unordered_map<std::vector<int>, Prefix, PrefixHash> pruned;
      for (int i = 0; i < (int)order.size() && i < beam_; ++i)
        pruned.emplace(*order[i].second, next[*order[i].second]);
      beam.swap(pruned);
    }

    // final: score trailing partial word too
    std::vector<std::pair<std::string, double>> out;
    for (auto& kv : beam) {
      double score = kv.second.total();
      if (lm_ && alpha_ != 0.0) {
        std::string tail = TrailingWord(kv.first);
        if (!tail.empty()) score += WordLmScore(kv.first, tail) ;
      }
      out.emplace_back(ToText(kv.first), score);
    }
    std::sort(out.begin(), out.end(), [](auto& a, auto& b) { return a.second > b.second; });
    if ((int)out.size() > nbest) out.resize(nbest);
    return out;
  }

 private:
  void Upsert(std::unordered_map<std::vector<int>, Prefix, PrefixHash>& m,
              const std::vector<int>& prefix, bool is_blank, double logp,
              double lm_score) {
    auto& e = m[prefix];
    if (e.chars.empty() && !prefix.empty()) e.chars = prefix;
    if (is_blank)
      e.p_b = log_sum_exp(e.p_b, logp);
    else
      e.p_nb = log_sum_exp(e.p_nb, logp);
    e.lm_score = lm_score;  // same prefix -> same LM score
  }

  // LM score to attach when extending prefix `np` (whose last char was just
  // added): if the added char is the space, score the word that ended.
  double LmExtend(const Prefix& p, const std::vector<int>& np) {
    if (!lm_ || alpha_ == 0.0) return p.lm_score;
    if (np.back() != space_) return p.lm_score;
    // word just completed = chars between previous space and this one
    std::vector<int> body(np.begin(), np.end() - 1);
    std::string w = TrailingWord(body);
    if (w.empty()) return p.lm_score;
    return p.lm_score + WordLmScore(body, w);
  }

  double WordLmScore(const std::vector<int>& prefix_body, const std::string& w) {
    // history = all completed words before this one
    std::vector<uint32_t> hist;
    std::string cur;
    std::vector<std::string> words;
    for (int c : prefix_body) {
      if (c == space_) {
        if (!cur.empty()) words.push_back(cur);
        cur.clear();
      } else {
        cur += vocab_[c];
      }
    }
    // `cur` is the word being scored (== w)
    for (auto& ww : words) hist.push_back(lm_->LookupId(ww));
    double log10p = lm_->Score(hist, lm_->LookupId(w));
    return alpha_ * log10p * std::log(10.0) + beta_;
  }

  std::string TrailingWord(const std::vector<int>& prefix) {
    std::string w;
    for (auto it = prefix.rbegin(); it != prefix.rend(); ++it) {
      if (*it == space_) break;
      w = vocab_[*it] + w;
    }
    return w;
  }

  std::string ToText(const std::vector<int>& prefix) {
    std::string s;
    for (int c : prefix) s += vocab_[c];
    return s;
  }

  std::vector<std::string> vocab_;
  int blank_;
  int beam_;
  double alpha_, beta_;
  const LmBase* lm_;
  int space_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* ctc_lm_load(const char* arpa_path) {
  auto* lm = new ArpaLM();
  if (!lm->Load(arpa_path)) {
    delete lm;
    return nullptr;
  }
  return static_cast<LmBase*>(lm);
}

// KenLM binary backend (explicit opt-in from Python). Dispatches on the
// file's own model_type: 0 (probing) -> kenlm_probing.h, 2-5 (the trie
// family incl. Bhiksha array variants) -> kenlm_trie.h; rest_probing gets
// an error that names exactly which types decode. On failure returns null
// and writes a precise reason into err_buf.
void* ctc_lm_load_kenlm_bin(const char* path, char* err_buf, int err_cap) {
  std::string err;
  LmBase* out = nullptr;
  {
    // header peek chooses the backend; each backend re-validates fully
    int fd = open(path, O_RDONLY);
    uint8_t head[4096];
    ssize_t n = fd >= 0 ? read(fd, head, sizeof(head)) : -1;
    if (fd >= 0) close(fd);
    kenlm_probing::HeaderInfo h;
    if (n <= 0 || !kenlm_probing::ParseHeader(head, (size_t)n, &h, &err)) {
      if (err.empty()) err = "cannot read " + std::string(path);
    } else if (h.model_type == 0) {
      auto* lm = new KenlmProbingLM();
      if (lm->Load(path, &err)) out = lm; else delete lm;
    } else if (h.model_type >= 2 && h.model_type <= 5) {
      auto* lm = new KenlmTrieLM();
      if (lm->Load(path, &err)) out = lm; else delete lm;
    } else {
      err = "KenLM model_type " + std::to_string(h.model_type) +
            " is not supported by the direct reader (probing and the full "
            "trie family — trie/quant_trie/array_trie/quant_array_trie — "
            "decode; rest_probing does not — dump it back to ARPA with "
            "kenlm)";
    }
  }
  if (!out && err_buf && err_cap > 0) {
    std::snprintf(err_buf, (size_t)err_cap, "%s", err.c_str());
  }
  return out;
}

// Backward-compatible name (pre-trie ABI); same dispatcher.
void* ctc_lm_load_kenlm_probing(const char* path, char* err_buf, int err_cap) {
  return ctc_lm_load_kenlm_bin(path, err_buf, err_cap);
}

// Word string for a KenLM vocab id when the binary carries its vocabulary
// strings (build_binary default); returns length or -1. Lets tests and
// load-time self-checks enumerate real words without an ARPA.
int ctc_lm_kenlm_word(void* lm_handle, uint32_t id, char* buf, int cap) {
  std::string w;
  if (auto* p = dynamic_cast<KenlmProbingLM*>(static_cast<LmBase*>(lm_handle))) {
    if (!p->model().has_word_strings()) return -1;
    w = p->model().WordString(id);
  } else if (auto* t = dynamic_cast<KenlmTrieLM*>(static_cast<LmBase*>(lm_handle))) {
    if (!t->model().has_word_strings()) return -1;
    w = t->model().WordString(id);
  } else {
    return -1;
  }
  if (w.empty() && id != 0) return -1;
  if ((int)w.size() + 1 > cap) return -1;
  std::memcpy(buf, w.c_str(), w.size() + 1);
  return (int)w.size();
}

void ctc_lm_free(void* lm) { delete static_cast<LmBase*>(lm); }

// log10 P(word | context) with Katz backoff; context is a space-separated
// word string ("" = unigram). Exposes the scorer for differential tests
// against real KenLM (tests/test_kenlm_differential.py) and for debugging.
double ctc_lm_score_word(void* lm_handle, const char* context_joined,
                         const char* word) {
  const auto* lm = static_cast<const LmBase*>(lm_handle);
  std::vector<uint32_t> ctx;
  std::istringstream ss(context_joined);
  std::string w;
  while (ss >> w) ctx.push_back(lm->LookupId(w));
  return lm->Score(ctx, lm->LookupId(word));
}

// Serialize a loaded LM to the flat binary cache format (fast reload for
// serving startup). Returns 0 on success.
int ctc_lm_save_binary(void* lm, const char* path) {
  if (!lm) return 1;
  auto* arpa = dynamic_cast<ArpaLM*>(static_cast<LmBase*>(lm));
  if (!arpa) return 3;  // KenLM-probing backend: already a binary, no cache
  return arpa->SaveBinary(path) ? 0 : 2;
}

// vocab: '\n'-joined labels (V entries, index = label id).
// Returns number of hypotheses written. Each hypothesis is written as
// "text\x01score" joined by '\x02' into out_buf (size out_cap).
int ctc_beam_search(const float* log_probs, int T, int V, const char* vocab_joined,
                    int blank_id, int beam_width, double alpha, double beta,
                    void* lm_handle, int nbest, char* out_buf, int out_cap) {
  std::vector<std::string> vocab;
  {
    std::string all(vocab_joined);
    size_t pos = 0;
    while (pos <= all.size()) {
      size_t nl = all.find('\n', pos);
      if (nl == std::string::npos) {
        vocab.push_back(all.substr(pos));
        break;
      }
      vocab.push_back(all.substr(pos, nl - pos));
      pos = nl + 1;
    }
  }
  int space_id = -1;
  for (size_t i = 0; i < vocab.size(); ++i)
    if (vocab[i] == " ") space_id = (int)i;

  BeamSearcher bs(vocab, blank_id, beam_width, alpha, beta,
                  static_cast<LmBase*>(lm_handle), space_id);
  auto res = bs.Search(log_probs, T, V, nbest);

  std::string packed;
  for (size_t i = 0; i < res.size(); ++i) {
    if (i) packed += '\x02';
    packed += res[i].first;
    packed += '\x01';
    packed += std::to_string(res[i].second);
  }
  if ((int)packed.size() + 1 > out_cap) return -1;
  std::memcpy(out_buf, packed.c_str(), packed.size() + 1);
  return (int)res.size();
}

}  // extern "C"
