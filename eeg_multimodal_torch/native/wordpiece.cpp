// Native WordPiece tokenizer for the serialized-sensor-row text path.
//
// The reference tokenizes each CSV row with the HF Python tokenizer
// (get_embedding.py:113-116), ~ms per row. This C++ implementation does
// greedy longest-match-first WordPiece with the same pre-tokenization the
// Python engine uses (whitespace split, '-' split off), over a vocab loaded
// as "surface\tid" lines. Exposed as a C ABI for ctypes (no pybind11 in the
// image). Throughput target: the whole 2402-row train split in single-digit
// milliseconds.
//
// API (all thread-safe after create):
//   void* wp_create(const char* vocab_blob, int cls_id, int sep_id,
//                   int pad_id, int unk_id);
//   void  wp_destroy(void* h);
//   // encode one text into out_ids/out_mask (each max_len int32)
//   void  wp_encode(void* h, const char* text, int max_len,
//                   int32_t* out_ids, int32_t* out_mask);
//   // batch: texts = '\n'-separated; out buffers are (n_texts, max_len)
//   int   wp_encode_batch(void* h, const char* texts, int max_len,
//                         int32_t* out_ids, int32_t* out_mask);
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct WordPiece {
  std::unordered_map<std::string, int32_t> vocab;
  // exact word -> id-sequence memo (RecoveredWordPiece.word_memo): observed
  // words must reproduce their recorded HF id runs verbatim, which greedy
  // matching over the recovered piece inventory cannot always do.
  std::unordered_map<std::string, std::vector<int32_t>> memo;
  int32_t cls_id, sep_id, pad_id, unk_id;
  size_t max_piece_chars = 1;

  // greedy longest-match over one word (no whitespace). Appends ids.
  void word(const char* s, size_t n, std::vector<int32_t>& out) const {
    if (!memo.empty()) {
      auto mit = memo.find(std::string(s, n));
      if (mit != memo.end()) {
        out.insert(out.end(), mit->second.begin(), mit->second.end());
        return;
      }
    }
    size_t start = 0;
    size_t before = out.size();
    std::string buf;
    while (start < n) {
      size_t end = n;
      if (end - start > max_piece_chars) end = start + max_piece_chars;
      bool found = false;
      for (; end > start; --end) {
        buf.clear();
        if (start > 0) buf += "##";
        buf.append(s + start, end - start);
        auto it = vocab.find(buf);
        if (it != vocab.end()) {
          out.push_back(it->second);
          start = end;
          found = true;
          break;
        }
      }
      if (!found) {
        out.resize(before);
        out.push_back(unk_id);
        return;
      }
    }
  }

  void encode(const char* text, size_t len, int max_len, int32_t* ids,
              int32_t* mask) const {
    std::vector<int32_t> toks;
    toks.reserve(128);
    toks.push_back(cls_id);
    size_t i = 0;
    while (i < len) {
      while (i < len && (text[i] == ' ' || text[i] == '\t')) ++i;
      if (i >= len) break;
      // split leading '-' signs as their own tokens (numeric punctuation)
      while (i < len && text[i] == '-') {
        word(text + i, 1, toks);
        ++i;
      }
      size_t j = i;
      while (j < len && text[j] != ' ' && text[j] != '\t') ++j;
      if (j > i) word(text + i, j - i, toks);
      i = j;
    }
    if ((int)toks.size() > max_len - 1) toks.resize(max_len - 1);
    toks.push_back(sep_id);
    int n = (int)toks.size();
    std::memcpy(ids, toks.data(), n * sizeof(int32_t));
    for (int t = 0; t < max_len; ++t) mask[t] = t < n ? 1 : 0;
    for (int t = n; t < max_len; ++t) ids[t] = pad_id;
  }
};

}  // namespace

extern "C" {

void* wp_create(const char* vocab_blob, int cls_id, int sep_id, int pad_id,
                int unk_id) {
  auto* wp = new WordPiece();
  wp->cls_id = cls_id;
  wp->sep_id = sep_id;
  wp->pad_id = pad_id;
  wp->unk_id = unk_id;
  const char* p = vocab_blob;
  while (*p) {
    const char* tab = std::strchr(p, '\t');
    if (!tab) break;
    const char* nl = std::strchr(tab, '\n');
    if (!nl) nl = tab + std::strlen(tab);
    std::string surface(p, tab - p);
    // value is either a single id ("piece\tid") or a comma-terminated id
    // list ("word\tid1,id2,") — the latter is a word-memo entry
    std::string value(tab + 1, nl - (tab + 1));
    if (value.find(',') != std::string::npos) {
      std::vector<int32_t> run;
      const char* q = value.c_str();
      while (*q) {
        char* end = nullptr;
        long v = std::strtol(q, &end, 10);
        if (end == q) break;
        run.push_back((int32_t)v);
        q = (*end == ',') ? end + 1 : end;
      }
      if (!run.empty()) wp->memo.emplace(std::move(surface), std::move(run));
    } else {
      int32_t id = (int32_t)std::strtol(value.c_str(), nullptr, 10);
      size_t chars = surface.rfind("##", 0) == 0 ? surface.size() - 2 : surface.size();
      if (chars > wp->max_piece_chars) wp->max_piece_chars = chars;
      wp->vocab.emplace(std::move(surface), id);
    }
    p = *nl ? nl + 1 : nl;
  }
  return wp;
}

void wp_destroy(void* h) { delete static_cast<WordPiece*>(h); }

void wp_encode(void* h, const char* text, int max_len, int32_t* out_ids,
               int32_t* out_mask) {
  static_cast<WordPiece*>(h)->encode(text, std::strlen(text), max_len,
                                     out_ids, out_mask);
}

int wp_encode_batch(void* h, const char* texts, int max_len, int32_t* out_ids,
                    int32_t* out_mask) {
  auto* wp = static_cast<WordPiece*>(h);
  int n = 0;
  const char* p = texts;
  // split semantics match Python "\n".join(texts): k separators => k+1
  // rows, empty rows included (they encode to [CLS][SEP] + padding)
  while (true) {
    const char* nl = std::strchr(p, '\n');
    size_t len = nl ? (size_t)(nl - p) : std::strlen(p);
    wp->encode(p, len, max_len, out_ids + (size_t)n * max_len,
               out_mask + (size_t)n * max_len);
    ++n;
    if (!nl) break;
    p = nl + 1;
  }
  return n;
}

}  // extern "C"
