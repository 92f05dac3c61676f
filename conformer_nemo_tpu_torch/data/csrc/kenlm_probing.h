// KenLM PROBING-format binary payload reader (read-only, mmap).
//
// Parity target: the reference's beam decoder scores directly with KenLM
// `.bin` models through the external `ctc_decoders` Scorer
// (NeMo's nemo/collections/asr/modules/beam_search_decoder.py:64).
// This reader serves the PROBING data structure (model_type 0, the
// build_binary default and the simpler of KenLM's two families); trie /
// quantized variants keep the actionable rejection in decode/kenlm_binary.py.
//
// Format (public KenLM binary layout, binary_format.cc semantics):
//   [header]   magic + sanity values + FixedWidthParameters + uint64 counts,
//              8-aligned end (parsed by scanning for the unambiguous sanity
//              byte pattern, same approach as decode/kenlm_binary.py).
//   [vocab]    ProbingVocabularyHeader {u64 version; u64 bound} then a
//              linear-probing hash table of {u64 murmur64a(word), u32 id}
//              entries; bucket count = max(n+1, multiplier*n). <unk> is id 0
//              and is NOT inserted (lookup miss => 0).
//   [unigram]  (counts[0]+1) x {f32 prob; f32 backoff}, indexed by word id.
//   [middle]   for orders 2..N-1: probing table of {u64 key; f32 prob;
//              f32 backoff}; key = chained CombineWordHash over word ids,
//              newest word first (see NgramKey below).
//   [longest]  order-N probing table of {u64 key; f32 prob}.
//   [words]    iff has_vocabulary: '\0'-separated word strings by id,
//              starting with "<unk>".
//
// Entry byte-widths that depend on the library's struct packing (the vocab
// and longest entries pack a u64 + one u32/f32: 12 packed vs 16 aligned)
// are RESOLVED FROM THE FILE, not assumed: the loader tries the candidate
// layouts and accepts exactly one that satisfies the total-size equation
// (exact when has_vocabulary=0; ends at "<unk>\0" when 1). A file that
// matches zero or several layouts is rejected with a precise error —
// mis-parsing that "loads" would be strictly worse.
//
// The murmur seed (0) and the CombineWordHash constants are KenLM's public
// hashing scheme; end-to-end per-word score parity against the real library
// is enforced by tests/test_kenlm_differential.py (importorskip-gated: runs
// wherever the kenlm wheel + build_binary exist). Without them the reader
// is validated structurally and against a layout-exact fixture writer
// (tests/test_kenlm_probing.py).

#pragma once

#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace kenlm_probing {

// MurmurHash64A (Austin Appleby, public domain); kenlm hashes vocab words
// with seed 0 (util::MurmurHash64A via detail::HashForVocab).
inline uint64_t Murmur64A(const void* key, size_t len, uint64_t seed = 0) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const unsigned char* data = static_cast<const unsigned char*>(key);
  const unsigned char* end = data + (len / 8) * 8;
  while (data != end) {
    uint64_t k;
    std::memcpy(&k, data, 8);
    data += 8;
    k *= m;
    k ^= k >> r;
    k *= m;
    h ^= k;
    h *= m;
  }
  switch (len & 7) {
    case 7: h ^= (uint64_t)data[6] << 48; [[fallthrough]];
    case 6: h ^= (uint64_t)data[5] << 40; [[fallthrough]];
    case 5: h ^= (uint64_t)data[4] << 32; [[fallthrough]];
    case 4: h ^= (uint64_t)data[3] << 24; [[fallthrough]];
    case 3: h ^= (uint64_t)data[2] << 16; [[fallthrough]];
    case 2: h ^= (uint64_t)data[1] << 8; [[fallthrough]];
    case 1: h ^= (uint64_t)data[0]; h *= m;
  }
  h ^= h >> r;
  h *= m;
  h ^= h >> r;
  return h;
}

// lm/search_hashed.hh detail::CombineWordHash: n-gram keys chain word ids
// newest-first starting from the raw id of the predicted word.
inline uint64_t CombineWordHash(uint64_t current, uint32_t next) {
  return (current * 8978948897894561157ULL) ^
         ((uint64_t)(1 + next) * 17894857484156487943ULL);
}

inline uint64_t Buckets(uint64_t entries, double multiplier) {
  uint64_t scaled = (uint64_t)(multiplier * (double)entries);
  return entries + 1 > scaled ? entries + 1 : scaled;
}

inline uint64_t Align8(uint64_t x) { return (x + 7) & ~(uint64_t)7; }

// Linear-probing lookup in a table of `esz`-byte entries whose first 8
// bytes are the key (0 = empty). Returns pointer to the value bytes.
inline const uint8_t* ProbeFind(const uint8_t* table, uint64_t buckets,
                                size_t esz, uint64_t key) {
  if (!buckets || key == 0) return nullptr;
  uint64_t i = key % buckets;
  for (uint64_t n = 0; n < buckets; ++n) {
    const uint8_t* e = table + i * esz;
    uint64_t k;
    std::memcpy(&k, e, 8);
    if (k == key) return e + 8;
    if (k == 0) return nullptr;
    if (++i == buckets) i = 0;
  }
  return nullptr;
}

struct HeaderInfo {
  int order = 0;
  double multiplier = 0.0;
  uint32_t model_type = ~0u;
  bool has_vocab = false;
  std::vector<uint64_t> counts;
  uint64_t model_base = 0;  // 8-aligned offset where payload starts
};

// Mirror of decode/kenlm_binary.py parse_header: locate the sanity block's
// unambiguous 24-byte reference pattern, then the params struct at one of
// the plausible paddings, then the counts (sequential or 8-aligned).
inline bool ParseHeader(const uint8_t* data, size_t size, HeaderInfo* out,
                        std::string* err) {
  static const char kMagic[] = "mmap lm http://kheafield.com/code format version ";
  const size_t magic_len = sizeof(kMagic) - 1;
  if (size < magic_len + 96 || std::memcmp(data, kMagic, magic_len) != 0) {
    *err = "not a KenLM binary (magic mismatch)";
    return false;
  }
  // Pin the format version: the payload layouts implemented here are the
  // version-5 ones. A future-version binary must be rejected explicitly,
  // not structurally (the size equation + vocab self-check are a backstop,
  // not a version check).
  {
    uint64_t ver = 0;
    size_t vp = magic_len;
    bool any = false;
    while (vp < size && data[vp] >= '0' && data[vp] <= '9') {
      ver = ver * 10 + (data[vp] - '0');
      ++vp;
      any = true;
    }
    if (!any || vp >= size || data[vp] != '\n' || ver != 5) {
      *err = "KenLM binary format version " +
             (any ? std::to_string(ver) : std::string("(unparsable)")) +
             " is not supported (this reader implements the version-5 "
             "layouts); dump the model back to ARPA with kenlm";
      return false;
    }
  }
  // reference-value pattern: f32 0.0, 1.0, -0.5; u32 1, u32 max; u64 1
  // (28 packed bytes — same pattern decode/kenlm_binary.py scans for)
  uint8_t sanity[28];
  {
    float f0 = 0.0f, f1 = 1.0f, f2 = -0.5f;
    uint32_t u1 = 1, umax = 0xFFFFFFFFu;
    uint64_t q1 = 1;
    std::memcpy(sanity + 0, &f0, 4);
    std::memcpy(sanity + 4, &f1, 4);
    std::memcpy(sanity + 8, &f2, 4);
    std::memcpy(sanity + 12, &u1, 4);
    std::memcpy(sanity + 16, &umax, 4);
    std::memcpy(sanity + 20, &q1, 8);
  }
  const size_t sanity_len = 28;
  size_t scan_end = size < 4096 ? size : 4096;
  size_t idx = (size_t)-1;
  for (size_t i = magic_len; i + sanity_len <= scan_end; ++i) {
    if (std::memcmp(data + i, sanity, sanity_len) == 0) {
      idx = i;
      break;
    }
  }
  if (idx == (size_t)-1) {
    *err = "KenLM binary: sanity block not found";
    return false;
  }
  size_t pos = idx + sanity_len;
  for (size_t pad : {(size_t)0, (size_t)4, (size_t)8}) {
    size_t p = pos + pad;
    if (p + 20 > scan_end) continue;
    int order = data[p];
    float mult;
    uint32_t mtype;
    std::memcpy(&mult, data + p + 4, 4);
    std::memcpy(&mtype, data + p + 8, 4);
    uint8_t has_vocab = data[p + 12];
    if (order < 1 || order > 9) continue;
    if (mtype > 5) continue;
    if ((mtype == 0 || mtype == 1) && !(mult >= 1.0f && mult <= 64.0f)) continue;
    if (has_vocab > 1) continue;
    for (size_t cstart : {p + 20, Align8(p + 20)}) {
      std::vector<uint64_t> counts;
      size_t cpos = cstart;
      bool ok = true;
      for (int i = 0; i < order; ++i) {
        if (cpos + 8 > scan_end) { ok = false; break; }
        uint64_t c;
        std::memcpy(&c, data + cpos, 8);
        uint64_t per_gram = (mtype <= 1) ? 4 : 1;
        if (c == 0 || c > size / per_gram + 1) { ok = false; break; }
        counts.push_back(c);
        cpos += 8;
      }
      if (!ok) continue;
      out->order = order;
      out->multiplier = mult;
      out->model_type = mtype;
      out->has_vocab = has_vocab != 0;
      out->counts = std::move(counts);
      out->model_base = Align8(cpos);
      return true;
    }
  }
  *err = "KenLM binary: parameter block failed validation";
  return false;
}

class Model {
 public:
  ~Model() {
    if (map_ != nullptr && map_ != MAP_FAILED) munmap(map_, map_size_);
  }

  bool Load(const std::string& path, std::string* err) {
    int fd = open(path.c_str(), O_RDONLY);
    if (fd < 0) {
      *err = "cannot open " + path;
      return false;
    }
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size <= 0) {
      close(fd);
      *err = "cannot stat " + path;
      return false;
    }
    map_size_ = (size_t)st.st_size;
    map_ = mmap(nullptr, map_size_, PROT_READ, MAP_SHARED, fd, 0);
    close(fd);
    if (map_ == MAP_FAILED) {
      map_ = nullptr;
      *err = "mmap failed for " + path;
      return false;
    }
    const uint8_t* data = static_cast<const uint8_t*>(map_);

    HeaderInfo h;
    if (!ParseHeader(data, map_size_, &h, err)) return false;
    if (h.model_type != 0) {
      *err = "KenLM model_type " + std::to_string(h.model_type) +
             " is not PROBING; only probing payloads are readable here";
      return false;
    }
    order_ = h.order;
    counts_ = h.counts;
    multiplier_ = h.multiplier;

    // Resolve packing-dependent entry widths from the total-size equation.
    const uint64_t c0 = counts_[0];
    const uint64_t vocab_buckets = Buckets(c0, multiplier_);
    uint64_t middle_total = 0;
    for (int o = 2; o <= order_ - 1; ++o)
      middle_total += Buckets(counts_[o - 1], multiplier_) * 16;
    const uint64_t longest_entries = order_ >= 2 ? counts_[order_ - 1] : 0;

    int n_match = 0;
    for (size_t ves : {(size_t)12, (size_t)16}) {
      for (size_t les : order_ >= 2 ? std::vector<size_t>{12, 16}
                                    : std::vector<size_t>{0}) {
        for (uint64_t uni_extra : {(uint64_t)1, (uint64_t)0}) {
          uint64_t expect = h.model_base + 16 /* vocab header */ +
                            vocab_buckets * ves + (c0 + uni_extra) * 8 +
                            middle_total +
                            Buckets(longest_entries, multiplier_) *
                                (order_ >= 2 ? les : 0);
          bool fits;
          if (h.has_vocab) {
            fits = expect + 6 <= map_size_ &&
                   std::memcmp(data + expect, "<unk>\0", 6) == 0;
          } else {
            fits = expect == map_size_;
          }
          if (fits) {
            ++n_match;
            vocab_entry_size_ = ves;
            longest_entry_size_ = les;
            unigram_extra_ = uni_extra;
            words_offset_ = h.has_vocab ? expect : 0;
          }
        }
      }
    }
    if (n_match != 1) {
      *err = "KenLM probing binary: " +
             std::string(n_match == 0 ? "no" : "multiple") +
             " payload layouts satisfy the file-size equation (file "
             "truncated, nonstandard build, or unsupported packing)";
      return false;
    }

    // Section pointers.
    uint64_t off = h.model_base;
    std::memcpy(&vocab_version_, data + off, 8);
    std::memcpy(&vocab_bound_, data + off + 8, 8);
    off += 16;
    vocab_table_ = data + off;
    vocab_buckets_ = vocab_buckets;
    off += vocab_buckets * vocab_entry_size_;
    unigram_ = reinterpret_cast<const float*>(data + off);
    off += (c0 + unigram_extra_) * 8;
    middle_.clear();
    middle_buckets_.clear();
    for (int o = 2; o <= order_ - 1; ++o) {
      middle_.push_back(data + off);
      uint64_t b = Buckets(counts_[o - 1], multiplier_);
      middle_buckets_.push_back(b);
      off += b * 16;
    }
    if (order_ >= 2) {
      longest_ = data + off;
      longest_buckets_ = Buckets(longest_entries, multiplier_);
      off += longest_buckets_ * longest_entry_size_;
    }

    // Structural spot-checks: version byte small, bound plausible, vocab
    // values within bound.
    if ((vocab_version_ & 0xFF) > 8 || vocab_bound_ > c0 + 2 ||
        vocab_bound_ == 0) {
      *err = "KenLM probing binary: vocabulary header failed validation";
      return false;
    }
    uint64_t check = vocab_buckets_ < 4096 ? vocab_buckets_ : 4096;
    uint64_t nonzero = 0;
    for (uint64_t i = 0; i < check; ++i) {
      const uint8_t* e = vocab_table_ + i * vocab_entry_size_;
      uint64_t k;
      uint32_t v;
      std::memcpy(&k, e, 8);
      std::memcpy(&v, e + 8, 4);
      if (k != 0) {
        ++nonzero;
        if (v >= vocab_bound_ + 1) {
          *err = "KenLM probing binary: vocab table value out of range";
          return false;
        }
      }
    }
    if (check == vocab_buckets_ && nonzero > c0) {
      *err = "KenLM probing binary: vocab table overfull";
      return false;
    }

    // Strong self-validation when the binary carries its word strings
    // (build_binary default): every stored word, murmur-hashed and probed
    // through the vocab table, must resolve to its own index. This proves
    // the hash function, seed, bucket formula, probing order and entry
    // packing against THIS file — not just plausibility. (The n-gram key
    // chain is still only provable against the real library; see the
    // gated differential tests.)
    if (words_offset_) {
      const char* p = reinterpret_cast<const char*>(map_) + words_offset_;
      const char* wend = reinterpret_cast<const char*>(map_) + map_size_;
      uint64_t checked = 0;
      for (uint32_t id = 0; p < wend && checked < 65536; ++id) {
        size_t len = strnlen(p, (size_t)(wend - p));
        if (len == 0 && id > 0) break;  // trailing padding
        std::string w(p, len);
        p += len + 1;
        if (id == 0) {
          // <unk> (or <UNK>) is id 0 and never inserted in the table
          if (w != "<unk>" && w != "<UNK>") {
            *err = "KenLM probing binary: word strings do not start with <unk>";
            return false;
          }
          continue;
        }
        if (WordId(w) != id) {
          *err = "KenLM probing binary: vocab self-check failed for word '" +
                 w + "' (hash scheme or table layout mismatch)";
          return false;
        }
        ++checked;
      }
    }
    return true;
  }

  int order() const { return order_; }

  uint32_t WordId(const std::string& w) const {
    uint64_t h = Murmur64A(w.data(), w.size());
    const uint8_t* val =
        ProbeFind(vocab_table_, vocab_buckets_, vocab_entry_size_, h);
    if (!val) return 0;  // <unk>
    uint32_t id;
    std::memcpy(&id, val, 4);
    return id;
  }

  // log10 P(w | context); context ids oldest-first, pre-clamped or not
  // (clamped to order-1 most recent here).
  double Score(const std::vector<uint32_t>& context, uint32_t w) const {
    size_t k = context.size();
    size_t use = (size_t)(order_ - 1) < k ? (size_t)(order_ - 1) : k;
    const uint32_t* ctx = context.data() + (k - use);

    // longest match extending leftward from the unigram
    float prob = UnigramProb(w);
    uint64_t node = w;
    size_t matched = 1;
    for (size_t j = 1; j <= use; ++j) {
      node = CombineWordHash(node, ctx[use - j]);
      size_t ng_order = j + 1;
      if ((int)ng_order == order_) {
        const uint8_t* val =
            ProbeFind(longest_, longest_buckets_, longest_entry_size_, node);
        if (val) {
          std::memcpy(&prob, val, 4);
          matched = ng_order;
        }
        break;
      }
      const uint8_t* val = ProbeFind(middle_[ng_order - 2],
                                     middle_buckets_[ng_order - 2], 16, node);
      if (!val) break;
      std::memcpy(&prob, val, 4);
      matched = ng_order;
    }

    // + backoffs of the context suffixes longer than the matched context
    double total = prob;
    for (size_t L = matched; L <= use; ++L) {
      float bo = 0.0f;
      if (L == 1) {
        bo = UnigramBackoff(ctx[use - 1]);
      } else {
        uint64_t n2 = ctx[use - 1];
        for (size_t j = 1; j <= L - 1; ++j)
          n2 = CombineWordHash(n2, ctx[use - 1 - j]);
        const uint8_t* val =
            ProbeFind(middle_[L - 2], middle_buckets_[L - 2], 16, n2);
        if (val) std::memcpy(&bo, val + 4, 4);
      }
      total += bo;
    }
    return total;
  }

  // id -> word string when the binary carries the vocabulary strings
  // (has_vocabulary); empty when absent or id out of range. Used by the
  // load-time differential self-check and tests.
  std::string WordString(uint32_t id) const {
    if (!words_offset_) return "";
    const char* p = reinterpret_cast<const char*>(map_) + words_offset_;
    const char* end = reinterpret_cast<const char*>(map_) + map_size_;
    for (uint32_t i = 0; p < end; ++i) {
      size_t len = strnlen(p, (size_t)(end - p));
      if (i == id) return std::string(p, len);
      p += len + 1;
    }
    return "";
  }

  bool has_word_strings() const { return words_offset_ != 0; }

 private:
  float UnigramProb(uint32_t w) const {
    if ((uint64_t)w >= counts_[0] + unigram_extra_) w = 0;
    return unigram_[2 * w];
  }
  float UnigramBackoff(uint32_t w) const {
    if ((uint64_t)w >= counts_[0] + unigram_extra_) w = 0;
    return unigram_[2 * w + 1];
  }

  void* map_ = nullptr;
  size_t map_size_ = 0;
  int order_ = 0;
  double multiplier_ = 0.0;
  std::vector<uint64_t> counts_;
  uint64_t vocab_version_ = 0, vocab_bound_ = 0;
  const uint8_t* vocab_table_ = nullptr;
  uint64_t vocab_buckets_ = 0;
  size_t vocab_entry_size_ = 0, longest_entry_size_ = 0;
  uint64_t unigram_extra_ = 1;
  const float* unigram_ = nullptr;
  std::vector<const uint8_t*> middle_;
  std::vector<uint64_t> middle_buckets_;
  const uint8_t* longest_ = nullptr;
  uint64_t longest_buckets_ = 0;
  uint64_t words_offset_ = 0;
};

}  // namespace kenlm_probing
