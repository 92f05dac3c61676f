// KenLM TRIE-format binary payload reader (read-only, mmap).
//
// Parity target: the reference's beam decoder consumes ANY KenLM `.bin`
// through the external `ctc_decoders` Scorer
// (NeMo's nemo/collections/asr/modules/beam_search_decoder.py:64),
// and `build_binary trie` is the variant KenLM's own docs recommend for
// memory-constrained serving. This reader serves model_type 2 (trie,
// non-quantized) and model_type 3 (quant_trie, separately-quantized
// prob/backoff tables); rest_probing (1) keeps the actionable rejection in
// decode/kenlm_binary.py, which names exactly which types decode.
//
// Model types 4 (array_trie) and 5 (quant_array_trie) —
// `build_binary -a <bits> trie` — decode too. Bhiksha compression
// (lm/bhiksha.hh/cc semantics) replaces each middle level's full-width next
// pointers with: an 8-byte section header {u8 version (0); u8 configured
// bits; 6 pad}, a u64 offset-bucket array, and only the LOW `inline_bits`
// of each next pointer stored in the bit-packed entry. The bucket array A
// satisfies A[h] = the first next-slot index whose pointer's high part
// (value >> inline_bits) reaches h (A[0] = 0; the end-sentinel slot writes
// its buckets with index = entry count); reading slot i recovers
// high = max{h : A[h] <= i}. inline_bits = RequiredBits(max_next) -
// ChopBits(max_offset, max_next, configured_bits), where ChopBits is
// kenlm's size-minimizing argmin over chop of
// (max_next >> (required-chop))*64 - max_offset*chop with max_offset =
// entries+1, and the bucket count is (max_next >> (required-chopped)) + 1.
// These formulas are load-bearing for the layout; they are cross-checked
// here by the same file-size equation + per-level structural validation
// (version byte, A[0]==0, monotone buckets bounded by the entry count,
// reconstructed end sentinel) and ground-truthed against real
// `build_binary -a` outputs in tests/test_kenlm_differential.py wherever
// the kenlm wheel exists. Unverified: upstream may pad each Bhiksha section
// to 8 bytes, which this reader does not; no real `build_binary -a` file
// has been read yet (ROADMAP.md, queue 3).
//
// Format (public KenLM binary layout, version 5; lm/trie, lm/vocab,
// lm/quantize semantics):
//   [header]   shared with kenlm_probing.h (ParseHeader).
//   [vocab]    SortedVocabulary: u64 stored-entry count, then `stored`
//              murmur64a(word) hashes sorted ascending. <unk> is id 0 and
//              never stored; a found hash at sorted index i has word id i+1.
//              The region is allocated for counts[0] hashes (one slack slot
//              when <unk> was present in the source ARPA).
//   [quant]    model_type 3 only: {u8 prob_bits; u8 backoff_bits; 6 pad},
//              then per middle order a float[2^prob_bits] prob table and a
//              float[2^backoff_bits] backoff table, then the order-N
//              float[2^prob_bits] prob table. Backoff table slots 0/1 hold
//              the reserved -0.0 / +0.0 (no-extension / extension) values.
//   [unigram]  (counts[0]+2) x {f32 prob; f32 backoff; u64 next}; word w's
//              children at level 2 are [next(w), next(w+1)).
//   [middle]   for orders 2..N-1: bit-packed array of (1+entries) slots of
//              total_bits = word_bits + quant_bits + next_bits, where
//              word_bits = RequiredBits(counts[0]), quant_bits = 63
//              (prob as non-positive-float31 then backoff as float32) or
//              prob_bits+backoff_bits (backoff index in the LOW bits, then
//              prob index — kenlm packs (prob<<backoff_bits)|backoff), and
//              next_bits = RequiredBits(counts[next order]). Entry i's
//              children range is [next_i, next_{i+1}); the final slot holds
//              the end sentinel. Byte size = ((1+entries)*total_bits+7)/8+8.
//   [longest]  order-N bit-packed array: word_bits + 31 (or prob_bits).
//   [words]    iff has_vocabulary: '\0'-separated strings by id, "<unk>"
//              first (same as probing).
//
// The trie is REVERSED: an n-gram "a b c" (c newest) lives on the path
// unigram[c] -> middle2 find b -> find a; each level's entries are sorted by
// word id within the parent's range (global order = lexicographic by
// reversed word sequence). Middle entries exist for every proper suffix of
// every stored n-gram; suffixes absent from the ARPA (pruned models) are
// BLANK entries carrying the longest real suffix's probability and a -0.0
// backoff — Score() mirrors kenlm's read path (model.cc ResumeScore), which
// takes the deepest found entry's stored prob, blank or not.
//
// Layout facts that this reader does not take on faith are RESOLVED FROM
// THE FILE with loud rejection on zero/multiple matches, exactly like the
// probing reader: the vocab region size and the RequiredBits convention
// (counts[o] vs counts[o]+1) are chosen by the total-size equation (exact
// when has_vocabulary=0; ends at "<unk>\0" when 1); the sorted-hash array
// must be strictly increasing; when word strings are present every word is
// hashed and binary-searched back to its own id at load time. End-to-end
// score parity against the real library is enforced by
// tests/test_kenlm_differential.py wherever the kenlm wheel exists; without
// it the reader is validated against the layout-exact fixture writer in
// tests/test_kenlm_trie.py.

#pragma once

#include "kenlm_probing.h"  // mmap-free helpers: Murmur64A, ParseHeader, Align8

#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace kenlm_trie {

using kenlm_probing::HeaderInfo;
using kenlm_probing::Murmur64A;
using kenlm_probing::ParseHeader;

// util/bit_packing.hh RequiredBits: bits to hold values 0..max_value.
inline uint8_t RequiredBits(uint64_t max_value) {
  if (!max_value) return 0;
  uint8_t ret = 1;
  while (max_value >>= 1) ++ret;
  return ret;
}

// lm/bhiksha.cc ChopBits: the number of HIGH next-pointer bits moved into
// the bucket array, chosen to minimize total size — argmin over
// chop <= min(RequiredBits(max_next), configured) of
//   bucket cost (max_next >> (required-chop)) * 64 bits
//   minus inline savings max_offset * chop bits
// (strict < keeps the smallest chop on ties). max_offset = entries + 1
// (the sentinel slot also stores a pointer).
inline uint8_t ChopBits(uint64_t max_offset, uint64_t max_next,
                        uint8_t configured_bits) {
  uint8_t required = RequiredBits(max_next);
  uint8_t limit = required < configured_bits ? required : configured_bits;
  uint8_t best_chop = 0;
  int64_t lowest_change = INT64_MAX;
  for (uint8_t chop = 0; chop <= limit; ++chop) {
    int64_t change = (int64_t)((max_next >> (required - chop)) * 64) -
                     (int64_t)(max_offset * (uint64_t)chop);
    if (change < lowest_change) {
      lowest_change = change;
      best_chop = chop;
    }
  }
  return best_chop;
}

// lm/bhiksha.cc ArrayCount: bucket-array length for the chosen chop.
inline uint64_t BhikshaArrayCount(uint64_t max_offset, uint64_t max_next,
                                  uint8_t configured_bits) {
  uint8_t required = RequiredBits(max_next);
  uint8_t chopped = ChopBits(max_offset, max_next, configured_bits);
  return (max_next >> (required - chopped)) + 1;
}

// Little-endian bit-packed reads (util/bit_packing.hh ReadInt57 semantics:
// load the u64 at byte bit_off/8, shift by bit_off%7, mask). Every array is
// allocated with 8 trailing slack bytes so the 8-byte load cannot run off
// the section.
inline uint64_t ReadBits(const uint8_t* base, uint64_t bit_off, uint8_t len) {
  uint64_t w;
  std::memcpy(&w, base + (bit_off >> 3), 8);
  w >>= (bit_off & 7);
  return len >= 64 ? w : (w & ((UINT64_C(1) << len) - 1));
}

// ReadNonPositiveFloat31: 31 stored bits are the f32 pattern with the (always
// set, probs are <= 0) sign bit dropped; restore it on read.
inline float ReadProb31(const uint8_t* base, uint64_t bit_off) {
  uint32_t i = (uint32_t)(ReadBits(base, bit_off, 31)) | 0x80000000u;
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}

inline float ReadF32Bits(const uint8_t* base, uint64_t bit_off) {
  uint32_t i = (uint32_t)ReadBits(base, bit_off, 32);
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}

struct NodeRange {
  uint64_t begin = 0, end = 0;
};

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
    if (h.model_type != 2 && h.model_type != 3 && h.model_type != 4 &&
        h.model_type != 5) {
      *err = "KenLM model_type " + std::to_string(h.model_type) +
             " is not in the trie family";
      return false;
    }
    quantized_ = (h.model_type == 3 || h.model_type == 5);
    bhiksha_ = (h.model_type >= 4);
    order_ = h.order;
    counts_ = h.counts;
    if (order_ < 2) {
      *err = "KenLM trie binary: order-1 models are not produced by kenlm "
             "(it requires at least a bigram model)";
      return false;
    }
    const uint64_t c0 = counts_[0];
    if (h.model_base + 8 > map_size_) {
      *err = "KenLM trie binary: truncated before the vocabulary";
      return false;
    }
    uint64_t stored;
    std::memcpy(&stored, data + h.model_base, 8);
    if (stored > c0 || stored + 1 < c0) {
      *err = "KenLM trie binary: vocabulary entry count " +
             std::to_string(stored) + " is implausible for unigram count " +
             std::to_string(c0);
      return false;
    }

    // Resolve the (few) layout facts not fixed by the counts: the vocab
    // region size and the RequiredBits convention. Exactly one candidate
    // combination must satisfy the total-size equation.
    uint64_t vocab_sizes[2] = {8 + 8 * c0, 8 + 8 * stored};
    int n_match = 0;
    std::vector<std::vector<uint64_t>> match_sigs;  // dedupe identical layouts
    for (int vi = 0; vi < 2; ++vi) {
      if (vi == 1 && vocab_sizes[1] == vocab_sizes[0]) continue;
      for (int bits_plus = 0; bits_plus < 2; ++bits_plus) {
        uint64_t search_base = h.model_base + vocab_sizes[vi];
        uint8_t pb = 0, bb = 0;
        uint64_t quant_size = 0;
        if (quantized_) {
          if (search_base + 8 > map_size_) continue;
          pb = data[search_base];
          bb = data[search_base + 1];
          // ReadInt25 bounds the index fields; 0 bits would collapse a table
          if (pb < 1 || pb > 25 || bb < 1 || bb > 25) continue;
          quant_size = 8 + ((order_ - 2) *
                            (((uint64_t)1 << pb) + ((uint64_t)1 << bb)) +
                            ((uint64_t)1 << pb)) * 4;
        }
        uint8_t wb = RequiredBits(c0 + bits_plus);
        uint64_t off = search_base + quant_size + (c0 + 2) * 16;
        std::vector<uint64_t> mid_offsets, mid_bits;
        std::vector<uint64_t> bh_offs, bh_counts;
        std::vector<uint8_t> next_bits;
        bool candidate_ok = true;
        for (int o = 2; o <= order_ - 1; ++o) {
          uint64_t entries = counts_[o - 1];
          uint8_t qb = quantized_ ? (uint8_t)(pb + bb) : 63;
          uint64_t max_next = counts_[o] + bits_plus;
          uint8_t nb = RequiredBits(max_next);
          if (bhiksha_) {
            // per-level Bhiksha section: 8-byte header + u64 bucket array
            if (off + 8 > map_size_ || data[off] != 0 /* version */) {
              candidate_ok = false;
              break;
            }
            uint8_t cfg = data[off + 1];
            uint64_t count = BhikshaArrayCount(entries + 1, max_next, cfg);
            bh_offs.push_back(off + 8);
            bh_counts.push_back(count);
            nb = (uint8_t)(nb - ChopBits(entries + 1, max_next, cfg));
            off += 8 + 8 * count;
          }
          uint64_t tb = (uint64_t)wb + qb + nb;
          mid_offsets.push_back(off);
          mid_bits.push_back(tb);
          next_bits.push_back(nb);
          off += ((1 + entries) * tb + 7) / 8 + 8;
        }
        if (!candidate_ok) continue;
        uint8_t lqb = quantized_ ? pb : 31;
        uint64_t ltb = (uint64_t)wb + lqb;
        uint64_t longest_off = off;
        off += ((1 + counts_[order_ - 1]) * ltb + 7) / 8 + 8;

        bool fits;
        if (h.has_vocab) {
          fits = off + 6 <= map_size_ &&
                 std::memcmp(data + off, "<unk>\0", 6) == 0;
        } else {
          fits = off == map_size_;
        }
        if (fits) {
          // two candidate combinations can denote the SAME layout when the
          // counts sit below a power of two (RequiredBits(c)==RequiredBits
          // (c+1)); only distinct layouts constitute ambiguity
          std::vector<uint64_t> sig{search_base, (uint64_t)wb, longest_off,
                                    ltb};
          sig.insert(sig.end(), mid_bits.begin(), mid_bits.end());
          sig.insert(sig.end(), mid_offsets.begin(), mid_offsets.end());
          sig.insert(sig.end(), bh_offs.begin(), bh_offs.end());
          sig.insert(sig.end(), bh_counts.begin(), bh_counts.end());
          bool dup = false;
          for (const auto& s : match_sigs) dup = dup || s == sig;
          if (dup) continue;
          match_sigs.push_back(sig);
          ++n_match;
          search_base_ = search_base;
          prob_bits_ = pb;
          backoff_bits_ = bb;
          quant_size_ = quant_size;
          word_bits_ = wb;
          mid_offsets_ = mid_offsets;
          mid_total_bits_ = mid_bits;
          mid_next_bits_ = next_bits;
          bhiksha_offs_ = bh_offs;
          bhiksha_counts_ = bh_counts;
          longest_off_ = longest_off;
          longest_total_bits_ = ltb;
          words_offset_ = h.has_vocab ? off : 0;
        }
      }
    }
    if (n_match != 1) {
      *err = "KenLM trie binary: " +
             std::string(n_match == 0 ? "no" : "multiple") +
             " payload layouts satisfy the file-size equation (file "
             "truncated, nonstandard build, or unsupported packing)";
      return false;
    }

    vocab_hashes_ = reinterpret_cast<const uint64_t*>(data + h.model_base + 8);
    vocab_stored_ = stored;
    unigram_ = data + search_base_ + quant_size_;
    if (quantized_) {
      const float* t = reinterpret_cast<const float*>(data + search_base_ + 8);
      for (int o = 2; o <= order_ - 1; ++o) {
        mid_prob_table_.push_back(t);
        t += (uint64_t)1 << prob_bits_;
        mid_backoff_table_.push_back(t);
        t += (uint64_t)1 << backoff_bits_;
      }
      longest_prob_table_ = t;
    }

    // --- load-time self-validation --------------------------------------
    // Sorted vocabulary: hashes strictly increasing (kenlm rejects hash
    // collisions at build time, so equality is corruption here too).
    for (uint64_t i = 1; i < vocab_stored_; ++i) {
      if (vocab_hashes_[i] <= vocab_hashes_[i - 1]) {
        *err = "KenLM trie binary: vocabulary hash array is not strictly "
               "sorted (corrupt file or wrong layout)";
        return false;
      }
    }
    // Unigram next pointers: monotone, bounded by the next level's count.
    uint64_t next_count = counts_[1];
    uint64_t prev = 0;
    for (uint64_t w = 0; w <= c0; ++w) {
      uint64_t nx = UniNext(w);
      if (nx < prev || nx > next_count) {
        *err = "KenLM trie binary: unigram next pointers are not monotone "
               "within the order-2 count (corrupt file or wrong layout)";
        return false;
      }
      prev = nx;
    }
    // Bhiksha bucket arrays: A[0] == 0, nondecreasing, values bounded by
    // the slot count (regular slots write their own index; the sentinel
    // writes the entry count).
    for (int o = 2; bhiksha_ && o <= order_ - 1; ++o) {
      const uint64_t* a = reinterpret_cast<const uint64_t*>(
          data + bhiksha_offs_[o - 2]);
      uint64_t count = bhiksha_counts_[o - 2];
      bool ok = (a[0] == 0);
      for (uint64_t i = 1; ok && i < count; ++i) {
        ok = (a[i] >= a[i - 1] && a[i] <= counts_[o - 1]);
      }
      if (!ok) {
        *err = "KenLM array-trie binary: order-" + std::to_string(o) +
               " Bhiksha bucket array violates its invariants (corrupt file "
               "or wrong layout)";
        return false;
      }
    }
    // Middle end sentinels: each level's final (reconstructed) next pointer
    // must not exceed the following level's count.
    for (int o = 2; o <= order_ - 1; ++o) {
      uint64_t entries = counts_[o - 1];
      uint64_t tb = mid_total_bits_[o - 2];
      uint8_t qb = quantized_ ? (uint8_t)(prob_bits_ + backoff_bits_) : 63;
      uint64_t sentinel = NextValue(o - 2, tb, qb, entries);
      if (sentinel > counts_[o]) {
        *err = "KenLM trie binary: order-" + std::to_string(o) +
               " end sentinel exceeds the next level's count";
        return false;
      }
    }
    // When the binary carries its word strings: every word must hash and
    // binary-search back to its own id (proves the hash, the sort, and the
    // id = index+1 convention against THIS file).
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
          if (w != "<unk>" && w != "<UNK>") {
            *err = "KenLM trie binary: word strings do not start with <unk>";
            return false;
          }
          continue;
        }
        if (WordId(w) != id) {
          *err = "KenLM trie binary: vocab self-check failed for word '" + w +
                 "' (hash scheme or sorted-array layout mismatch)";
          return false;
        }
        ++checked;
      }
    }
    return true;
  }

  int order() const { return order_; }
  bool quantized() const { return quantized_; }
  bool has_word_strings() const { return words_offset_ != 0; }

  uint32_t WordId(const std::string& w) const {
    uint64_t h = Murmur64A(w.data(), w.size());
    uint64_t lo = 0, hi = vocab_stored_;
    while (lo < hi) {
      uint64_t mid = (lo + hi) / 2;
      if (vocab_hashes_[mid] < h) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < vocab_stored_ && vocab_hashes_[lo] == h) {
      return (uint32_t)(lo + 1);  // <unk> is 0 and is not stored
    }
    return 0;
  }

  // log10 P(w | context); context word ids oldest-first. Mirrors kenlm's
  // model.cc read path: walk the reverse trie from unigram[w] through the
  // context newest-first, take the deepest found entry's stored probability
  // (blank entries included — they carry the longest real suffix's prob),
  // then add the backoffs of the context suffixes longer than the match.
  double Score(const std::vector<uint32_t>& context, uint32_t w) const {
    size_t k = context.size();
    size_t use = (size_t)(order_ - 1) < k ? (size_t)(order_ - 1) : k;
    const uint32_t* ctx = context.data() + (k - use);

    float prob = UniProb(w);
    size_t matched = 1;
    NodeRange range{UniNext(w), UniNext(w + 1)};
    for (size_t j = 1; j <= use; ++j) {
      uint32_t cw = ctx[use - j];
      size_t level = j + 1;
      if ((int)level == order_) {
        float p;
        if (LongestFind(range, cw, &p)) {
          prob = p;
          matched = level;
        }
        break;
      }
      float p, bo;
      NodeRange next;
      if (!MiddleFind((int)level, range, cw, &p, &bo, &next)) break;
      prob = p;
      matched = level;
      range = next;
    }

    double total = prob;
    // backoff of the context suffix of length L (newest L context words),
    // for every L the match did not cover
    for (size_t L = matched; L <= use; ++L) {
      float bo = 0.0f;
      if (L == 1) {
        bo = UniBackoff(ctx[use - 1]);
      } else {
        NodeRange r{UniNext(ctx[use - 1]), UniNext(ctx[use - 1] + 1)};
        float p, b2 = 0.0f;
        bool ok = true;
        for (size_t j = 1; j + 1 <= L; ++j) {
          NodeRange next;
          if (!MiddleFind((int)(j + 1), r, ctx[use - 1 - j], &p, &b2, &next)) {
            ok = false;
            break;
          }
          r = next;
        }
        if (ok) bo = b2;
      }
      total += bo;
    }
    return total;
  }

  // id -> word string when the binary carries the vocabulary strings.
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

 private:
  float UniProb(uint32_t w) const {
    float f;
    std::memcpy(&f, unigram_ + (uint64_t)w * 16, 4);
    return f;
  }
  float UniBackoff(uint32_t w) const {
    float f;
    std::memcpy(&f, unigram_ + (uint64_t)w * 16 + 4, 4);
    return f;
  }
  uint64_t UniNext(uint64_t w) const {
    uint64_t v;
    std::memcpy(&v, unigram_ + w * 16 + 8, 8);
    return v;
  }

  // Binary search for `word` in the sorted word fields of [range.begin,
  // range.end) at the given level's bit-packed array.
  bool FindWord(const uint8_t* base, uint64_t tb, const NodeRange& range,
                uint32_t word, uint64_t* index) const {
    uint64_t lo = range.begin, hi = range.end;
    while (lo < hi) {
      uint64_t mid = lo + (hi - lo) / 2;
      uint64_t found = ReadBits(base, mid * tb, word_bits_);
      if (found < word) {
        lo = mid + 1;
      } else if (found > word) {
        hi = mid;
      } else {
        *index = mid;
        return true;
      }
    }
    return false;
  }

  bool MiddleFind(int level, const NodeRange& range, uint32_t word,
                  float* prob, float* backoff, NodeRange* next) const {
    const uint8_t* base =
        static_cast<const uint8_t*>(map_) + mid_offsets_[level - 2];
    uint64_t tb = mid_total_bits_[level - 2];
    uint64_t i;
    if (!FindWord(base, tb, range, word, &i)) return false;
    uint64_t off = i * tb + word_bits_;
    uint8_t qb;
    if (quantized_) {
      // kenlm packs (prob_index << backoff_bits) | backoff_index
      uint64_t bi = ReadBits(base, off, backoff_bits_);
      uint64_t pi = ReadBits(base, off + backoff_bits_, prob_bits_);
      *backoff = mid_backoff_table_[level - 2][bi];
      *prob = mid_prob_table_[level - 2][pi];
      qb = (uint8_t)(prob_bits_ + backoff_bits_);
    } else {
      *prob = ReadProb31(base, off);
      *backoff = ReadF32Bits(base, off + 31);
      qb = 63;
    }
    next->begin = NextValue(level - 2, tb, qb, i);
    next->end = NextValue(level - 2, tb, qb, i + 1);
    return true;
  }

  // Bucket-array high bits for next-slot `key` at middle level index `li`:
  // largest h with A[h] <= key (A[0] == 0, so one always exists). See the
  // header comment for why this recovers value(key) >> inline_bits.
  uint64_t BucketHigh(size_t li, uint64_t key) const {
    const uint64_t* a = reinterpret_cast<const uint64_t*>(
        static_cast<const uint8_t*>(map_) + bhiksha_offs_[li]);
    uint64_t lo = 0, hi = bhiksha_counts_[li];
    while (lo + 1 < hi) {
      uint64_t mid = (lo + hi) / 2;
      if (a[mid] <= key) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    return lo;
  }

  // Full next pointer stored at slot i of middle level index `li` (slots =
  // the level's entries plus the end sentinel at i == entries).
  uint64_t NextValue(size_t li, uint64_t tb, uint8_t qb, uint64_t i) const {
    const uint8_t* base =
        static_cast<const uint8_t*>(map_) + mid_offsets_[li];
    uint8_t nb = mid_next_bits_[li];
    uint64_t v = ReadBits(base, i * tb + word_bits_ + qb, nb);
    if (bhiksha_) v |= BucketHigh(li, i) << nb;
    return v;
  }

  bool LongestFind(const NodeRange& range, uint32_t word, float* prob) const {
    const uint8_t* base = static_cast<const uint8_t*>(map_) + longest_off_;
    uint64_t tb = longest_total_bits_;
    uint64_t i;
    if (!FindWord(base, tb, range, word, &i)) return false;
    uint64_t off = i * tb + word_bits_;
    if (quantized_) {
      *prob = longest_prob_table_[ReadBits(base, off, prob_bits_)];
    } else {
      *prob = ReadProb31(base, off);
    }
    return true;
  }

  void* map_ = nullptr;
  size_t map_size_ = 0;
  int order_ = 0;
  bool quantized_ = false;
  bool bhiksha_ = false;
  std::vector<uint64_t> counts_;
  const uint64_t* vocab_hashes_ = nullptr;
  uint64_t vocab_stored_ = 0;
  uint64_t search_base_ = 0, quant_size_ = 0;
  uint8_t prob_bits_ = 0, backoff_bits_ = 0, word_bits_ = 0;
  const uint8_t* unigram_ = nullptr;
  std::vector<uint64_t> mid_offsets_, mid_total_bits_;
  std::vector<uint8_t> mid_next_bits_;
  std::vector<uint64_t> bhiksha_offs_, bhiksha_counts_;
  std::vector<const float*> mid_prob_table_, mid_backoff_table_;
  const float* longest_prob_table_ = nullptr;
  uint64_t longest_off_ = 0, longest_total_bits_ = 0;
  uint64_t words_offset_ = 0;
};

}  // namespace kenlm_trie
