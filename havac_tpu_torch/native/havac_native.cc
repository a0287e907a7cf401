// Native ingestion core: multi-FASTA and HMMER3 .hmm parsing, C ABI.
//
// The TPU-native equivalent of the reference's vendored C submodules —
// FastaVector (FASTA parse + global/local coordinate support) and P7HmmReader
// (HMMER3 text parser), see SURVEY.md §2.4 — plus the 2-bit encode of
// SequencePreprocessor (host/sequence/SequencePreprocessor.cpp:37-85) with
// deterministic, position-keyed ambiguity resolution (SplitMix64, matching
// havac_tpu/utils/prng.py bit-for-bit so native and Python paths agree).
//
// Exposed as a C ABI consumed via ctypes (havac_tpu/native/__init__.py);
// semantics mirror the pure-Python parsers in havac_tpu/io/ exactly — the
// test suite asserts byte-identical outputs on both paths.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <algorithm>
#include <thread>
#include <utility>

namespace {

// ---------------------------------------------------------------- utilities

uint64_t splitmix(uint64_t v, uint64_t seed) {
  uint64_t z = v + seed * 0x9E3779B97F4A7C15ULL;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

std::string strip(const std::string& s) {
  size_t a = 0, b = s.size();
  while (a < b && std::isspace(static_cast<unsigned char>(s[a]))) a++;
  while (b > a && std::isspace(static_cast<unsigned char>(s[b - 1]))) b--;
  return s.substr(a, b - a);
}

bool read_file(const char* path, std::string* out, std::string* err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    *err = std::string("cannot open ") + path;
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(&(*out)[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  if (got != static_cast<size_t>(n)) {
    *err = std::string("short read on ") + path;
    return false;
  }
  return true;
}

std::vector<std::string> split_lines(const std::string& text) {
  std::vector<std::string> lines;
  size_t start = 0;
  for (size_t i = 0; i <= text.size(); i++) {
    if (i == text.size() || text[i] == '\n') {
      lines.emplace_back(text.substr(start, i - start));
      start = i + 1;
    }
  }
  return lines;
}

// Symbol classes, identical to havac_tpu/io/fasta.py:_ENCODE_TABLE:
// 0-3 direct (a c g t/u), 4-9 two-way IUPAC (r y s w k m), 10 uniform-random.
struct EncodeTable {
  uint8_t cls[256];
  EncodeTable() {
    for (int i = 0; i < 256; i++) cls[i] = 10;
    auto set = [&](char c, uint8_t v) {
      cls[static_cast<unsigned char>(std::tolower(c))] = v;
      cls[static_cast<unsigned char>(std::toupper(c))] = v;
    };
    set('a', 0); set('c', 1); set('g', 2); set('t', 3); set('u', 3);
    const char* two = "ryswkm";
    for (int i = 0; i < 6; i++) set(two[i], static_cast<uint8_t>(4 + i));
  }
};
const EncodeTable kEncode;
const uint8_t kTwoWay[6][2] = {{0, 2}, {1, 3}, {1, 2}, {0, 3}, {2, 3}, {0, 1}};

// ------------------------------------------------------------------- FASTA

struct Fasta {
  std::vector<std::string> names;
  std::vector<int64_t> lengths;
  std::string data;  // all sequences concatenated, no separators
  std::vector<int64_t> offsets;  // per-seq offset into data
  std::string err;
};

Fasta* fasta_parse(const char* path) {
  Fasta* fa = new Fasta();
  std::string text;
  if (!read_file(path, &text, &fa->err)) return fa;
  bool have_record = false;
  for (const std::string& raw : split_lines(text)) {
    std::string line = strip(raw);
    if (line.empty()) continue;
    if (line[0] == '>') {
      std::string rest = line.substr(1);
      size_t sp = rest.find_first_of(" \t");
      fa->names.push_back(sp == std::string::npos ? rest : rest.substr(0, sp));
      fa->offsets.push_back(static_cast<int64_t>(fa->data.size()));
      fa->lengths.push_back(0);
      have_record = true;
    } else {
      if (!have_record) {
        fa->err = std::string(path) + ": FASTA data before first '>' header";
        return fa;
      }
      fa->data += line;
      fa->lengths.back() += static_cast<int64_t>(line.size());
    }
  }
  if (!have_record) fa->err = std::string(path) + ": no FASTA records found";
  return fa;
}

// --------------------------------------------------------------------- HMM

struct Model {
  std::string name, acc, desc, alph;
  int64_t leng = -1, maxl = -1;
  double mu = 0, lambda = 0;
  int card = 4;
  bool has_stats = false;
  std::vector<float> scores;  // leng * card, row-major, +inf for '*'
};

struct Hmm {
  std::vector<Model> models;
  std::string err;
};

int alphabet_cardinality(const std::string& alph) {
  if (alph == "dna" || alph == "rna") return 4;
  if (alph == "amino") return 20;
  return -1;
}

bool parse_model(const std::vector<std::string>& lines, size_t* idx,
                 const char* path, Model* m, std::string* err) {
  size_t i = *idx;
  std::string header = strip(lines[i]);
  if (header.rfind("HMMER3", 0) != 0) {
    *err = std::string(path) + ": model does not start with 'HMMER3'";
    return false;
  }
  i++;
  while (i < lines.size()) {
    std::string stripped = strip(lines[i]);
    if (stripped.rfind("HMM", 0) == 0 && stripped.rfind("HMMER", 0) != 0) break;
    size_t sp = stripped.find_first_of(" \t");
    std::string key = sp == std::string::npos ? stripped : stripped.substr(0, sp);
    std::string value =
        sp == std::string::npos ? "" : strip(stripped.substr(sp + 1));
    if (key == "NAME") m->name = value;
    else if (key == "ACC") m->acc = value;
    else if (key == "DESC") m->desc = value;
    else if (key == "LENG") m->leng = std::atoll(value.c_str());
    else if (key == "MAXL") m->maxl = std::atoll(value.c_str());
    else if (key == "ALPH") {
      m->alph = value;
      for (auto& c : m->alph) c = std::tolower(static_cast<unsigned char>(c));
    } else if (key == "STATS") {
      char kind[32] = {0}, sub[32] = {0};
      double mu, lam;
      if (std::sscanf(value.c_str(), "%31s %31s %lf %lf", kind, sub, &mu,
                      &lam) == 4 &&
          std::strcmp(kind, "LOCAL") == 0 && std::strcmp(sub, "MSV") == 0) {
        m->mu = mu;
        m->lambda = lam;
        m->has_stats = true;
      }
    }
    i++;
  }
  if (i >= lines.size()) {
    *err = std::string(path) + ": model '" + m->name + "' has no HMM section";
    return false;
  }
  m->card = alphabet_cardinality(m->alph);
  if (m->leng <= 0 || m->alph.empty() || m->card < 0 || !m->has_stats) {
    *err = std::string(path) + ": model '" + m->name +
           "' missing LENG/ALPH/STATS LOCAL MSV";
    return false;
  }
  if (m->maxl <= 0) m->maxl = 4 * m->leng;

  i += 2;  // "HMM A C G T" header + transition header
  if (i < lines.size() && strip(lines[i]).rfind("COMPO", 0) == 0) {
    i += 3;
  } else {
    i += 2;
  }

  m->scores.resize(static_cast<size_t>(m->leng) * m->card);
  for (int64_t pos = 0; pos < m->leng; pos++) {
    if (i >= lines.size()) {
      *err = std::string(path) + ": model '" + m->name + "' truncated";
      return false;
    }
    const char* p = lines[i].c_str();
    char* end = nullptr;
    long node = std::strtol(p, &end, 10);
    if (end == p || node != pos + 1) {
      *err = std::string(path) + ": model '" + m->name + "': bad node index";
      return false;
    }
    p = end;
    for (int a = 0; a < m->card; a++) {
      while (*p && std::isspace(static_cast<unsigned char>(*p))) p++;
      if (*p == '*' ) {
        m->scores[pos * m->card + a] = INFINITY;
        p++;
      } else {
        double v = std::strtod(p, &end);
        if (end == p) {
          *err = std::string(path) + ": model '" + m->name +
                 "': bad score token";
          return false;
        }
        m->scores[pos * m->card + a] = static_cast<float>(v);
        p = end;
      }
    }
    i += 3;  // skip insert-emission + transition lines
  }
  while (i < lines.size() && strip(lines[i]) != "//") i++;
  if (i >= lines.size()) {
    *err = std::string(path) + ": model '" + m->name + "' missing '//'";
    return false;
  }
  *idx = i + 1;
  return true;
}

Hmm* hmm_parse(const char* path) {
  Hmm* h = new Hmm();
  std::string text;
  if (!read_file(path, &text, &h->err)) return h;
  std::vector<std::string> lines = split_lines(text);
  size_t i = 0;
  while (i < lines.size()) {
    if (strip(lines[i]).empty()) {
      i++;
      continue;
    }
    Model m;
    if (!parse_model(lines, &i, path, &m, &h->err)) return h;
    h->models.push_back(std::move(m));
  }
  if (h->models.empty() && h->err.empty())
    h->err = std::string(path) + ": no models found";
  return h;
}

}  // namespace

// ------------------------------------------------------------------- C ABI

extern "C" {

void* hv_fasta_open(const char* path) { return fasta_parse(path); }
const char* hv_fasta_error(void* h) { return static_cast<Fasta*>(h)->err.c_str(); }
int64_t hv_fasta_num(void* h) {
  return static_cast<int64_t>(static_cast<Fasta*>(h)->names.size());
}
void hv_fasta_lengths(void* h, int64_t* out) {
  Fasta* fa = static_cast<Fasta*>(h);
  std::memcpy(out, fa->lengths.data(), fa->lengths.size() * sizeof(int64_t));
}
const char* hv_fasta_name(void* h, int64_t i) {
  return static_cast<Fasta*>(h)->names[static_cast<size_t>(i)].c_str();
}

// Encode the concatenated database into `out` (padded_len bytes):
// seq0, SEP, seq1, SEP, ..., PAD — 2-bit codes with deterministic
// position-keyed randomization of separators/pads/ambiguity codes
// (SequencePreprocessor.cpp:37-85 semantics, made stateless).
// Returns the number of symbols written, or -1 if padded_len is smaller
// than the concatenated database (sum of lengths + one separator each) —
// the buffer size is caller-provided and must not be trusted blindly.
int64_t hv_fasta_encode(void* h, uint8_t* out, int64_t padded_len,
                        uint64_t seed) {
  Fasta* fa = static_cast<Fasta*>(h);
  int64_t needed = 0;
  for (size_t s = 0; s < fa->names.size(); s++) needed += fa->lengths[s] + 1;
  if (padded_len < needed) return -1;
  int64_t gp = 0;
  auto emit = [&](uint8_t cls) {
    uint8_t code;
    if (cls < 4) {
      code = cls;
    } else if (cls < 10) {
      uint64_t hbits = splitmix(static_cast<uint64_t>(gp), seed);
      code = kTwoWay[cls - 4][hbits & 1ULL];
    } else {
      uint64_t hbits = splitmix(static_cast<uint64_t>(gp), seed);
      code = static_cast<uint8_t>(hbits & 3ULL);
    }
    out[gp++] = code;
  };
  for (size_t s = 0; s < fa->names.size(); s++) {
    const char* p = fa->data.data() + fa->offsets[s];
    for (int64_t k = 0; k < fa->lengths[s]; k++)
      emit(kEncode.cls[static_cast<unsigned char>(p[k])]);
    emit(10);  // separator
  }
  while (gp < padded_len) emit(10);  // pad
  return gp;
}
void hv_fasta_close(void* h) { delete static_cast<Fasta*>(h); }

void* hv_hmm_open(const char* path) { return hmm_parse(path); }
const char* hv_hmm_error(void* h) { return static_cast<Hmm*>(h)->err.c_str(); }
int64_t hv_hmm_count(void* h) {
  return static_cast<int64_t>(static_cast<Hmm*>(h)->models.size());
}
static Model* model_at(void* h, int64_t i) {
  return &static_cast<Hmm*>(h)->models[static_cast<size_t>(i)];
}
int64_t hv_hmm_leng(void* h, int64_t i) { return model_at(h, i)->leng; }
int64_t hv_hmm_maxl(void* h, int64_t i) { return model_at(h, i)->maxl; }
double hv_hmm_mu(void* h, int64_t i) { return model_at(h, i)->mu; }
double hv_hmm_lambda(void* h, int64_t i) { return model_at(h, i)->lambda; }
int hv_hmm_card(void* h, int64_t i) { return model_at(h, i)->card; }
const char* hv_hmm_name(void* h, int64_t i) { return model_at(h, i)->name.c_str(); }
const char* hv_hmm_acc(void* h, int64_t i) { return model_at(h, i)->acc.c_str(); }
const char* hv_hmm_desc(void* h, int64_t i) { return model_at(h, i)->desc.c_str(); }
const char* hv_hmm_alph(void* h, int64_t i) { return model_at(h, i)->alph.c_str(); }
void hv_hmm_scores(void* h, int64_t i, float* out) {
  Model* m = model_at(h, i);
  std::memcpy(out, m->scores.data(), m->scores.size() * sizeof(float));
}
void hv_hmm_close(void* h) { delete static_cast<Hmm*>(h); }

}  // extern "C"

// ------------------------------------------------- hit path (decode/sort/
// resolve)
//
// The host side of hit reporting (`host/Havac.cpp:104-187` + the bitmap
// decode the reference does on-FPGA in `device/HitReporting.cpp`). These
// run in Python worker threads via ctypes (GIL released), replacing numpy
// paths that are bandwidth-bound on single-core hosts: per-chunk SWAR
// record decode, the global (row, position) sort, and coordinate
// resolution.

namespace {

inline uint64_t hit_key(int64_t row, int64_t pos) {
  // rows < 2^24 and positions < 2^38 in any realistic run; the engine's
  // numpy fallback uses the same composite ordering.
  return (static_cast<uint64_t>(row) << 38) | static_cast<uint64_t>(pos);
}

void sort_pairs(int64_t* rows, int64_t* pos, int64_t n, int nthreads);

struct HitVec {
  std::vector<int64_t> rows, pos;
};

}  // namespace

extern "C" {

// Expand SWAR bitmap records to (row, position) pairs, sorted by
// (row, pos). ids[e] = (block*num_strips + strip)*3 + flush; words[e] is a
// packed 3x10-bit bitmap (field f bit (9-r) = hit at row
// strip*30 + flush*10 + r, position block*3*W3 + f*W3 + word_idx[e]).
// rows_out/pos_out must hold 30*n entries; returns the hit count.
int64_t hv_decode_swar_flat(const int64_t* ids, const int64_t* word_idx,
                            const uint32_t* words, int64_t n,
                            int64_t num_strips, int64_t block_words,
                            int64_t* rows_out, int64_t* pos_out) {
  const int64_t W3 = block_words;
  const int64_t W = 3 * W3;
  int64_t m = 0;
  for (int64_t e = 0; e < n; e++) {
    const uint32_t w = words[e];
    if (!w) continue;
    const int64_t id = ids[e];
    const int64_t flush = id % 3;
    const int64_t bs = id / 3;
    const int64_t block = bs / num_strips;
    const int64_t strip = bs % num_strips;
    const int64_t row_base = strip * 30 + flush * 10;
    const int64_t pos_base = block * W + word_idx[e];
    for (int f = 0; f < 3; f++) {
      uint32_t field = (w >> (10 * f)) & 0x3FF;
      if (!field) continue;
      const int64_t p = pos_base + f * W3;
      while (field) {
        const int bit = 31 - __builtin_clz(field);  // highest set bit
        rows_out[m] = row_base + (9 - bit);
        pos_out[m] = p;
        m++;
        field &= ~(1u << bit);
      }
    }
  }
  sort_pairs(rows_out, pos_out, m, 1);  // chunks parallelize above us
  return m;
}

// v2 of the record decode: threaded two-pass expand (per-thread popcount
// prefix then parallel bit expansion, preserving record order) and an
// optional final (row, pos) sort. The engine's pipelined/mesh paths pass
// do_sort=0 — they globally re-sort the merged chunks anyway, and at
// genomic hit densities the per-chunk sort was the dominant decode cost
// (the reference's analog work is its host-side hit walk,
// `host/Havac.cpp:145-187`).
int64_t hv_decode_swar_flat_v2(const int64_t* ids, const int64_t* word_idx,
                               const uint32_t* words, int64_t n,
                               int64_t num_strips, int64_t block_words,
                               int64_t* rows_out, int64_t* pos_out,
                               int nthreads, int do_sort) {
  const int64_t W3 = block_words;
  const int64_t W = 3 * W3;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  if (n < (1 << 15)) nthreads = 1;  // expansion setup not worth it
  std::vector<int64_t> offs(static_cast<size_t>(nthreads) + 1, 0);
  std::vector<std::thread> threads;
  auto count_range = [&](int t) {
    const int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    int64_t c = 0;
    for (int64_t e = lo; e < hi; e++)
      c += __builtin_popcount(words[e] & 0x3FFFFFFFu);
    offs[t + 1] = c;
  };
  for (int t = 1; t < nthreads; t++) threads.emplace_back(count_range, t);
  count_range(0);
  for (auto& th : threads) th.join();
  threads.clear();
  for (int t = 0; t < nthreads; t++) offs[t + 1] += offs[t];
  auto expand_range = [&](int t) {
    const int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    int64_t m = offs[t];
    for (int64_t e = lo; e < hi; e++) {
      const uint32_t w = words[e] & 0x3FFFFFFFu;
      if (!w) continue;
      const int64_t id = ids[e];
      const int64_t flush = id % 3;
      const int64_t bs = id / 3;
      const int64_t block = bs / num_strips;
      const int64_t strip = bs % num_strips;
      const int64_t row_base = strip * 30 + flush * 10;
      const int64_t pos_base = block * W + word_idx[e];
      for (int f = 0; f < 3; f++) {
        uint32_t field = (w >> (10 * f)) & 0x3FF;
        if (!field) continue;
        const int64_t p = pos_base + f * W3;
        while (field) {
          const int bit = 31 - __builtin_clz(field);  // highest set bit
          rows_out[m] = row_base + (9 - bit);
          pos_out[m] = p;
          m++;
          field &= ~(1u << bit);
        }
      }
    }
  };
  for (int t = 1; t < nthreads; t++) threads.emplace_back(expand_range, t);
  expand_range(0);
  for (auto& th : threads) th.join();
  const int64_t m = offs[nthreads];
  if (do_sort) sort_pairs(rows_out, pos_out, m, nthreads);
  return m;
}

// In-place parallel sort of parallel (row, position) arrays by (row, pos).
void hv_sort_hits(int64_t* rows, int64_t* pos, int64_t n, int nthreads) {
  sort_pairs(rows, pos, n, nthreads);
}

// Resolve global (row, position) hits to local coordinates, dropping
// padding/separator hits (`Havac::getHitsFromFinishedRun`,
// `host/Havac.cpp:145-187`): sequence side via binary search over starts,
// model side via model-length prefix sums. Order-preserving compaction;
// returns the kept count.
int64_t hv_resolve_hits(const int64_t* rows, const int64_t* pos, int64_t n,
                        const int64_t* starts, const int64_t* lengths,
                        int64_t nseq, const int64_t* prefix, int64_t nmodels,
                        int64_t* seq_idx, int64_t* seq_pos,
                        int64_t* model_idx, int64_t* model_pos,
                        int nthreads) {
  if (n == 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  const int64_t total_rows = prefix[nmodels];
  std::vector<int64_t> counts(static_cast<size_t>(nthreads), 0);
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    const int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    int64_t m = lo;  // compact within [lo, hi) in place
    for (int64_t e = lo; e < hi; e++) {
      const int64_t gp = pos[e];
      if (gp < 0) continue;
      // upper_bound(starts, gp) - 1
      const int64_t* ub = std::upper_bound(starts, starts + nseq + 1, gp);
      const int64_t si = (ub - starts) - 1;
      if (si < 0 || si >= nseq) continue;
      const int64_t local = gp - starts[si];
      if (local >= lengths[si]) continue;  // separator / pad
      const int64_t row = rows[e];
      if (row < 0 || row >= total_rows) continue;
      const int64_t* mb = std::upper_bound(prefix, prefix + nmodels + 1, row);
      const int64_t mi = (mb - prefix) - 1;
      seq_idx[m] = si;
      seq_pos[m] = local;
      model_idx[m] = mi;
      model_pos[m] = row - prefix[mi];
      m++;
    }
    counts[static_cast<size_t>(t)] = m - lo;
  };
  for (int t = 0; t < nthreads; t++) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  //

  // Serial order-preserving compaction of the per-slice runs.
  int64_t out = counts[0];
  for (int t = 1; t < nthreads; t++) {
    const int64_t lo = n * t / nthreads;
    const int64_t c = counts[static_cast<size_t>(t)];
    if (lo != out && c) {
      std::memmove(seq_idx + out, seq_idx + lo, sizeof(int64_t) * c);
      std::memmove(seq_pos + out, seq_pos + lo, sizeof(int64_t) * c);
      std::memmove(model_idx + out, model_idx + lo, sizeof(int64_t) * c);
      std::memmove(model_pos + out, model_pos + lo, sizeof(int64_t) * c);
    }
    out += c;
  }
  return out;
}

}  // extern "C"

namespace {

// Parallel keyed sort shared by sort_pairs / hv_sort_order: fills ``keyed``
// with ((row<<38)|pos, source index) sorted ascending.
void sort_keyed(const int64_t* rows, const int64_t* pos, int64_t n,
                int nthreads,
                std::vector<std::pair<uint64_t, int64_t>>& keyed) {
  keyed.resize(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; i++)
    keyed[static_cast<size_t>(i)] = {hit_key(rows[i], pos[i]), i};
  if (nthreads > 1 && n > (1 << 18)) {
    // Sort slices in parallel, then merge pairwise.
    int t = 1;
    while (t * 2 <= nthreads) t *= 2;  // power of two
    std::vector<int64_t> bounds;
    for (int i = 0; i <= t; i++) bounds.push_back(n * i / t);
    std::vector<std::thread> threads;
    for (int i = 0; i < t; i++)
      threads.emplace_back([&, i] {
        std::sort(keyed.begin() + bounds[static_cast<size_t>(i)],
                  keyed.begin() + bounds[static_cast<size_t>(i) + 1]);
      });
    for (auto& th : threads) th.join();
    for (int width = 1; width < t; width *= 2) {
      std::vector<std::thread> mergers;
      for (int i = 0; i + width < t; i += 2 * width) {
        mergers.emplace_back([&, i] {
          std::inplace_merge(
              keyed.begin() + bounds[static_cast<size_t>(i)],
              keyed.begin() + bounds[static_cast<size_t>(i + width)],
              keyed.begin() + bounds[static_cast<size_t>(
                  std::min(i + 2 * width, t))]);
        });
      }
      for (auto& th : mergers) th.join();
    }
  } else {
    std::sort(keyed.begin(), keyed.end());
  }
}

void sort_pairs(int64_t* rows, int64_t* pos, int64_t n, int nthreads) {
  if (n <= 1) return;
  std::vector<std::pair<uint64_t, int64_t>> keyed;
  sort_keyed(rows, pos, n, nthreads, keyed);
  std::vector<int64_t> r2(static_cast<size_t>(n)), p2(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; i++) {
    const int64_t src = keyed[static_cast<size_t>(i)].second;
    r2[static_cast<size_t>(i)] = rows[src];
    p2[static_cast<size_t>(i)] = pos[src];
  }
  std::memcpy(rows, r2.data(), sizeof(int64_t) * static_cast<size_t>(n));
  std::memcpy(pos, p2.data(), sizeof(int64_t) * static_cast<size_t>(n));
}

}  // namespace

extern "C" {

// Permutation that sorts (rows, pos) by (row, pos) — the parallel analog of
// np.argsort over the composite key, for callers that must reorder extra
// parallel columns (the engine's resolved-hit merge).
void hv_sort_order(const int64_t* rows, const int64_t* pos, int64_t n,
                   int nthreads, int64_t* order) {
  if (n <= 0) return;
  std::vector<std::pair<uint64_t, int64_t>> keyed;
  sort_keyed(rows, pos, n, nthreads, keyed);
  for (int64_t i = 0; i < n; i++)
    order[i] = keyed[static_cast<size_t>(i)].second;
}

// Permutation that MERGES k already-sorted runs of (rows, pos) — the tail
// of the engine's overlapped sort design: per-chunk sorts run in collector
// threads while the device sweeps (free when device-bound), so the
// after-sweep tail only pays this O(n·log k) pairwise merge instead of a
// full O(n·log n) sort. offs has k+1 entries (run r = [offs[r], offs[r+1])
// within the concatenated arrays); order receives the global permutation.
void hv_merge_runs(const int64_t* rows, const int64_t* pos, int64_t n,
                   const int64_t* offs, int64_t k, int nthreads,
                   int64_t* order) {
  if (n <= 0) return;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  std::vector<std::pair<uint64_t, int64_t>> keyed(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; i++)
    keyed[static_cast<size_t>(i)] = {hit_key(rows[i], pos[i]), i};
  // Pairwise in-place merges, independent pairs of runs in parallel.
  std::vector<int64_t> bounds(offs, offs + k + 1);
  int64_t width = 1;
  while (width < k) {
    std::vector<std::thread> mergers;
    for (int64_t i = 0; i + width < k; i += 2 * width) {
      auto job = [&, i] {
        std::inplace_merge(
            keyed.begin() + bounds[static_cast<size_t>(i)],
            keyed.begin() + bounds[static_cast<size_t>(i + width)],
            keyed.begin() + bounds[static_cast<size_t>(
                std::min(i + 2 * width, k))]);
      };
      if (static_cast<int>(mergers.size()) < nthreads - 1)
        mergers.emplace_back(job);
      else
        job();
    }
    for (auto& th : mergers) th.join();
    width *= 2;
  }
  for (int64_t i = 0; i < n; i++)
    order[i] = keyed[static_cast<size_t>(i)].second;
}

// Threaded 64-bit gather: dst[i] = src[order[i]] — reordering resolved-hit
// columns by a precomputed sort permutation at memory speed.
void hv_permute_i64(const int64_t* src, const int64_t* order, int64_t n,
                    int64_t* dst, int nthreads) {
  if (n <= 0) return;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++)
    threads.emplace_back([&, t] {
      const int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
      for (int64_t i = lo; i < hi; i++) dst[i] = src[order[i]];
    });
  for (auto& th : threads) th.join();
}

}  // extern "C"

// --------------------------------------------- fused per-chunk hit pipeline
//
// Round-5 host path: one native pass per chunk replaces the numpy
// decode → bounds-filter → resolve chain (each a full sweep over 16 B/hit
// int64 arrays — at genomic density the host side cost ~69 s of the 150k
// run, more than 2× the device sweep). A hit's raw identity is ONE uint64
// key ((global_row << 38) | global_pos — the same composite hv_sort_hits
// keys by), and resolved coordinates are four int32 columns; per-hit state
// shrinks from ~48 B across three passes to 8 B + 16 B across one. The
// reference's analog is its on-FPGA bitmap walk + host prefix-sum
// resolution (`device/HitReporting.cpp`, `host/Havac.cpp:104-187`).

namespace {

constexpr uint64_t kPosMask = (1ull << 38) - 1;

// Shared record-expansion skeleton: calls emit(local_row, local_pos) for
// every hit bit that passes the (row < Pc, pos < Lc) bounds filter.
// idx[e] flattens (slot, word) over tile_words; ometa maps slot → tile id
// (NULL ⇒ identity: dense chunks allocate slots in grid order).
template <typename Emit>
inline void expand_records(const int64_t* idx, const uint32_t* words,
                           int64_t lo_e, int64_t hi_e, const int32_t* ometa,
                           int64_t tile_words, int64_t num_strips,
                           int64_t block_words, int64_t Pc, int64_t Lc,
                           Emit&& emit) {
  const int64_t W3 = block_words;
  const int64_t W = 3 * W3;
  for (int64_t e = lo_e; e < hi_e; e++) {
    const uint32_t w = words[e] & 0x3FFFFFFFu;
    if (!w) continue;
    const int64_t fl = idx[e];
    const int64_t slot = fl / tile_words;
    const int64_t word_idx = fl % tile_words;
    const int64_t id = ometa ? ometa[slot] : slot;
    const int64_t flush = id % 3;
    const int64_t bs = id / 3;
    const int64_t block = bs / num_strips;
    const int64_t strip = bs % num_strips;
    const int64_t row_base = strip * 30 + flush * 10;
    const int64_t pos_base = block * W + word_idx;
    const int64_t t = Pc - row_base;  // valid rows in this word's 10-row span
    if (t <= 0) continue;
    for (int f = 0; f < 3; f++) {
      uint32_t field = (w >> (10 * f)) & 0x3FF;
      if (!field) continue;
      const int64_t p = pos_base + f * W3;
      if (p >= Lc) continue;
      if (t < 10) field &= ~((1u << (10 - t)) - 1);  // bit b ⇒ row_base+9−b
      while (field) {
        const int bit = 31 - __builtin_clz(field);
        emit(row_base + (9 - bit), p);
        field &= ~(1u << bit);
      }
    }
  }
}

// Parallel ascending sort of a bare uint64 array (slice sorts + pairwise
// in-place merges, same shape as sort_keyed but with no payload).
void sort_keys_u64(uint64_t* keys, int64_t n, int nthreads) {
  if (n <= 1) return;
  if (nthreads > 1 && n > (1 << 18)) {
    int t = 1;
    while (t * 2 <= nthreads) t *= 2;
    std::vector<int64_t> bounds;
    for (int i = 0; i <= t; i++) bounds.push_back(n * i / t);
    std::vector<std::thread> threads;
    for (int i = 0; i < t; i++)
      threads.emplace_back([&, i] {
        std::sort(keys + bounds[static_cast<size_t>(i)],
                  keys + bounds[static_cast<size_t>(i) + 1]);
      });
    for (auto& th : threads) th.join();
    for (int width = 1; width < t; width *= 2) {
      std::vector<std::thread> mergers;
      for (int i = 0; i + width < t; i += 2 * width) {
        mergers.emplace_back([&, i] {
          std::inplace_merge(
              keys + bounds[static_cast<size_t>(i)],
              keys + bounds[static_cast<size_t>(i + width)],
              keys + bounds[static_cast<size_t>(std::min(i + 2 * width, t))]);
        });
      }
      for (auto& th : mergers) th.join();
    }
  } else {
    std::sort(keys, keys + n);
  }
}

}  // namespace

extern "C" {

// Count the hits of one chunk's records that survive the bounds filter —
// the exact-size allocation pass for hv_chunk_keys (popcount-speed: whole
// 10-row fields count via __builtin_popcount with a one-mask row clip).
int64_t hv_chunk_count(const int64_t* idx, const uint32_t* words, int64_t n,
                       const int32_t* ometa, int64_t tile_words,
                       int64_t num_strips, int64_t block_words, int64_t Pc,
                       int64_t Lc, int nthreads) {
  if (n <= 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  if (n < (1 << 14)) nthreads = 1;
  std::vector<int64_t> counts(static_cast<size_t>(nthreads), 0);
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    const int64_t W3 = block_words;
    const int64_t W = 3 * W3;
    const int64_t lo_e = n * t / nthreads, hi_e = n * (t + 1) / nthreads;
    int64_t c = 0;
    for (int64_t e = lo_e; e < hi_e; e++) {
      const uint32_t w = words[e] & 0x3FFFFFFFu;
      if (!w) continue;
      const int64_t fl = idx[e];
      const int64_t slot = fl / tile_words;
      const int64_t id = ometa ? ometa[slot] : slot;
      const int64_t flush = id % 3;
      const int64_t bs = id / 3;
      const int64_t strip = bs % num_strips;
      const int64_t row_base = strip * 30 + flush * 10;
      const int64_t tvr = Pc - row_base;
      if (tvr <= 0) continue;
      const uint32_t rmask =
          tvr < 10 ? ~((1u << (10 - tvr)) - 1) & 0x3FFu : 0x3FFu;
      const int64_t pos_base = (bs / num_strips) * W + fl % tile_words;
      for (int f = 0; f < 3; f++) {
        const uint32_t field = (w >> (10 * f)) & rmask;
        if (field && pos_base + f * W3 < Lc)
          c += __builtin_popcount(field);
      }
    }
    counts[static_cast<size_t>(t)] = c;
  };
  for (int t = 1; t < nthreads; t++) threads.emplace_back(work, t);
  work(0);
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (int64_t c : counts) total += c;
  return total;
}

// Expand one chunk's records to SORTED global uint64 hit keys
// ((row + r0) << 38 | (pos + lo)); keys must hold hv_chunk_count entries.
// Returns the count written (== hv_chunk_count with the same arguments).
int64_t hv_chunk_keys(const int64_t* idx, const uint32_t* words, int64_t n,
                      const int32_t* ometa, int64_t tile_words,
                      int64_t num_strips, int64_t block_words, int64_t Pc,
                      int64_t Lc, int64_t r0, int64_t lo, uint64_t* keys,
                      int nthreads) {
  if (n <= 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  if (n < (1 << 14)) nthreads = 1;
  std::vector<int64_t> offs(static_cast<size_t>(nthreads) + 1, 0);
  std::vector<std::thread> threads;
  auto count_range = [&](int t) {
    const int64_t lo_e = n * t / nthreads, hi_e = n * (t + 1) / nthreads;
    int64_t c = 0;
    expand_records(idx, words, lo_e, hi_e, ometa, tile_words, num_strips,
                   block_words, Pc, Lc, [&](int64_t, int64_t) { c++; });
    offs[t + 1] = c;
  };
  for (int t = 1; t < nthreads; t++) threads.emplace_back(count_range, t);
  count_range(0);
  for (auto& th : threads) th.join();
  threads.clear();
  for (int t = 0; t < nthreads; t++) offs[t + 1] += offs[t];
  auto fill_range = [&](int t) {
    const int64_t lo_e = n * t / nthreads, hi_e = n * (t + 1) / nthreads;
    int64_t m = offs[t];
    expand_records(idx, words, lo_e, hi_e, ometa, tile_words, num_strips,
                   block_words, Pc, Lc, [&](int64_t row, int64_t p) {
                     keys[m++] = (static_cast<uint64_t>(row + r0) << 38) |
                                 static_cast<uint64_t>(p + lo);
                   });
  };
  for (int t = 1; t < nthreads; t++) threads.emplace_back(fill_range, t);
  fill_range(0);
  for (auto& th : threads) th.join();
  const int64_t m = offs[nthreads];
  sort_keys_u64(keys, m, nthreads);
  return m;
}

// Resolve SORTED global hit keys to local coordinates as four int32
// columns, dropping padding/separator hits (semantics identical to
// hv_resolve_hits; exploits sortedness with cursor hints — rows are
// non-decreasing so the model cursor only advances, and consecutive
// positions cluster within a sequence so the bsearch is usually skipped).
// keys_out receives the kept keys compacted in order (may alias nothing);
// all outputs must hold n entries. Returns the kept count.
int64_t hv_resolve_keys(const uint64_t* keys, int64_t n,
                        const int64_t* starts, const int64_t* lengths,
                        int64_t nseq, const int64_t* prefix, int64_t nmodels,
                        int32_t* seq_idx, int32_t* seq_pos,
                        int32_t* model_idx, int32_t* model_pos,
                        uint64_t* keys_out, int nthreads) {
  if (n <= 0) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  if (n < (1 << 15)) nthreads = 1;
  const int64_t total_rows = prefix[nmodels];
  std::vector<int64_t> counts(static_cast<size_t>(nthreads), 0);
  std::vector<std::thread> threads;
  auto work = [&](int t) {
    const int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
    int64_t m = lo;
    int64_t mi = 0;   // model cursor: rows are non-decreasing
    int64_t si = -1;  // sequence hint: consecutive positions cluster
    for (int64_t e = lo; e < hi; e++) {
      const uint64_t key = keys[e];
      const int64_t row = static_cast<int64_t>(key >> 38);
      const int64_t gp = static_cast<int64_t>(key & kPosMask);
      if (row >= total_rows) continue;
      while (mi + 1 < nmodels && row >= prefix[mi + 1]) mi++;
      if (si < 0 || gp < starts[si] || gp >= starts[si + 1]) {
        const int64_t* ub = std::upper_bound(starts, starts + nseq + 1, gp);
        si = (ub - starts) - 1;
      }
      if (si < 0 || si >= nseq) { si = -1; continue; }
      const int64_t local = gp - starts[si];
      if (local >= lengths[si]) continue;  // separator / pad
      seq_idx[m] = static_cast<int32_t>(si);
      seq_pos[m] = static_cast<int32_t>(local);
      model_idx[m] = static_cast<int32_t>(mi);
      model_pos[m] = static_cast<int32_t>(row - prefix[mi]);
      keys_out[m] = key;
      m++;
    }
    counts[static_cast<size_t>(t)] = m - lo;
  };
  for (int t = 0; t < nthreads; t++) threads.emplace_back(work, t);
  for (auto& th : threads) th.join();
  int64_t out = counts[0];
  for (int t = 1; t < nthreads; t++) {
    const int64_t lo = n * t / nthreads;
    const int64_t c = counts[static_cast<size_t>(t)];
    if (lo != out && c) {
      std::memmove(seq_idx + out, seq_idx + lo, sizeof(int32_t) * c);
      std::memmove(seq_pos + out, seq_pos + lo, sizeof(int32_t) * c);
      std::memmove(model_idx + out, model_idx + lo, sizeof(int32_t) * c);
      std::memmove(model_pos + out, model_pos + lo, sizeof(int32_t) * c);
      std::memmove(keys_out + out, keys_out + lo, sizeof(uint64_t) * c);
    }
    out += c;
  }
  return out;
}

// Permutation that merges k already-sorted runs of uint64 keys — the
// key-form analog of hv_merge_runs (same pairwise in-place merge plan).
void hv_merge_runs_u64(const uint64_t* keys, int64_t n, const int64_t* offs,
                       int64_t k, int nthreads, int64_t* order) {
  if (n <= 0) return;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  std::vector<std::pair<uint64_t, int64_t>> keyed(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; i++)
    keyed[static_cast<size_t>(i)] = {keys[i], i};
  std::vector<int64_t> bounds(offs, offs + k + 1);
  int64_t width = 1;
  while (width < k) {
    std::vector<std::thread> mergers;
    for (int64_t i = 0; i + width < k; i += 2 * width) {
      auto job = [&, i] {
        std::inplace_merge(
            keyed.begin() + bounds[static_cast<size_t>(i)],
            keyed.begin() + bounds[static_cast<size_t>(i + width)],
            keyed.begin() + bounds[static_cast<size_t>(
                std::min(i + 2 * width, k))]);
      };
      if (static_cast<int>(mergers.size()) < nthreads - 1)
        mergers.emplace_back(job);
      else
        job();
    }
    for (auto& th : mergers) th.join();
    width *= 2;
  }
  for (int64_t i = 0; i < n; i++)
    order[i] = keyed[static_cast<size_t>(i)].second;
}

// Threaded 32-bit gather: dst[i] = src[order[i]] (int32 resolved columns).
void hv_permute_i32(const int32_t* src, const int64_t* order, int64_t n,
                    int32_t* dst, int nthreads) {
  if (n <= 0) return;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++)
    threads.emplace_back([&, t] {
      const int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
      for (int64_t i = lo; i < hi; i++) dst[i] = src[order[i]];
    });
  for (auto& th : threads) th.join();
}

// Place segments of k runs' int32 columns into ncols output columns, in
// one threaded pass (the pipeline's tail: each run's resolved table is cut
// into (run, row) segments whose output offsets follow from the launch
// rectangles, `engine/pipeline.py` `_placement`). Segment s copies entries
// [src[s], src[s] + dst[s+1] - dst[s]) of run run[s] to [dst[s], dst[s+1]);
// dst is ascending with dst[0] = 0 and dst[nseg] the output's length.
// cols[r * ncols + c] is run r's column c, out[c] the output's column c.
// Each thread owns one contiguous range of the output, so it first-touches
// its own pages; a segment that crosses a range's edge is split there.
void hv_place_i32(const int32_t* const* cols, int64_t ncols,
                  const int64_t* run, const int64_t* src, const int64_t* dst,
                  int64_t nseg, int32_t* const* out, int nthreads) {
  const int64_t n = nseg > 0 ? dst[nseg] : 0;
  if (n <= 0) return;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  if (n < (1 << 16)) nthreads = 1;
  auto work = [&](int t) {
    const int64_t a = n * t / nthreads, b = n * (t + 1) / nthreads;
    // The last segment that starts at or before a.
    int64_t s = (std::upper_bound(dst, dst + nseg + 1, a) - dst) - 1;
    for (; s < nseg && dst[s] < b; s++) {
      const int64_t x0 = std::max(a, dst[s]), x1 = std::min(b, dst[s + 1]);
      if (x1 <= x0) continue;
      const int64_t from = src[s] + (x0 - dst[s]);
      for (int64_t c = 0; c < ncols; c++)
        std::memcpy(out[c] + x0, cols[run[s] * ncols + c] + from,
                    sizeof(int32_t) * static_cast<size_t>(x1 - x0));
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < nthreads; t++) threads.emplace_back(work, t);
  work(0);
  for (auto& th : threads) th.join();
}

// Split uint64 hit keys back to int64 (row, pos) pairs — the lazy
// raw_hits() materialization.
void hv_keys_to_pairs(const uint64_t* keys, int64_t n, int64_t* rows,
                      int64_t* pos, int nthreads) {
  if (n <= 0) return;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++)
    threads.emplace_back([&, t] {
      const int64_t lo = n * t / nthreads, hi = n * (t + 1) / nthreads;
      for (int64_t i = lo; i < hi; i++) {
        rows[i] = static_cast<int64_t>(keys[i] >> 38);
        pos[i] = static_cast<int64_t>(keys[i] & kPosMask);
      }
    });
  for (auto& th : threads) th.join();
}

}  // extern "C"

// ------------------------------------------------------- ASan self-test main
//
// Built by `make debug` with -fsanitize=address (the reference ships an ASan
// debug target per tool, `test/hmmerValidation/makefile:19-20`). Parses every
// argv path as both FASTA and HMM, encodes FASTA databases into exactly-sized
// and deliberately undersized buffers, and exits 0 as long as nothing
// crashes — malformed inputs must surface as error strings, never as memory
// errors (which ASan turns into a nonzero exit).

#ifdef HAVAC_NATIVE_SELFTEST
int main(int argc, char** argv) {
  for (int a = 1; a < argc; a++) {
    {
      void* h = hv_fasta_open(argv[a]);
      const char* err = hv_fasta_error(h);
      if (err && err[0]) {
        std::printf("fasta %s: ERROR %s\n", argv[a], err);
      } else {
        int64_t n = hv_fasta_num(h);
        std::vector<int64_t> lens(static_cast<size_t>(n));
        if (n) hv_fasta_lengths(h, lens.data());
        int64_t needed = 0;
        for (int64_t k = 0; k < n; k++) needed += lens[static_cast<size_t>(k)] + 1;
        std::vector<uint8_t> buf(static_cast<size_t>(needed + 64));
        int64_t wrote = hv_fasta_encode(h, buf.data(), needed + 64, 0x5A5A);
        // Undersized buffer must be rejected, not overflowed.
        int64_t reject = needed > 0
            ? hv_fasta_encode(h, buf.data(), needed - 1, 0x5A5A) : 0;
        std::printf("fasta %s: %lld seqs, wrote %lld, undersized->%lld\n",
                    argv[a], static_cast<long long>(n),
                    static_cast<long long>(wrote),
                    static_cast<long long>(reject));
        for (int64_t k = 0; k < n; k++) (void)hv_fasta_name(h, k);
      }
      hv_fasta_close(h);
    }
    {
      void* h = hv_hmm_open(argv[a]);
      const char* err = hv_hmm_error(h);
      if (err && err[0]) {
        std::printf("hmm %s: ERROR %s\n", argv[a], err);
      } else {
        int64_t n = hv_hmm_count(h);
        for (int64_t k = 0; k < n; k++) {
          std::vector<float> sc(static_cast<size_t>(
              hv_hmm_leng(h, k) * hv_hmm_card(h, k)));
          hv_hmm_scores(h, k, sc.data());
          (void)hv_hmm_name(h, k);
          (void)hv_hmm_alph(h, k);
        }
        std::printf("hmm %s: %lld models\n", argv[a],
                    static_cast<long long>(n));
      }
      hv_hmm_close(h);
    }
  }
  return 0;
}
#endif  // HAVAC_NATIVE_SELFTEST
