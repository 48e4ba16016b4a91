"""WordPiece tokenization for serialized sensor rows, fully offline.

The port's own copy of the JAX package's ``data/tokenizer.py`` (host code,
no tensors): the same engines, vocabularies and recovery, so the two
packages give equal ids. ``default_tokenizer_for_coef`` reads the port's
copy of the recovered vocab, ``recovered_vocab_uncased.json`` beside this
file.

The reference serializes each CSV row to a space-joined string of ints and
BERT-tokenizes it with ``padding='max_length', truncation, max_length=512``
(ref: python/src/data/get_embedding.py:113-116). The strings are purely
numeric ("14 -2 2 -7 ... -2084"), so the only vocabulary that matters is
digit/number tokens plus [CLS]/[SEP]/[PAD].

This module provides:

- :class:`WordPiece` — a standard greedy longest-match-first WordPiece engine
  (whitespace pre-split + '-' punctuation split, '##' continuations), loading
  any standard vocab.txt when available;
- :func:`recover_numeric_vocab` — reconstructs the *numeric subset* of
  bert-base-uncased's vocab by aligning the reference's committed tokenized
  test pickle with the test CSV (the number string of every row is known, so
  greedy-match structure lets us attribute id->surface string). This gives
  exact token-id parity for the reference data without any network access;
- :func:`synthetic_numeric_vocab` — a deterministic fallback vocab (digits,
  sign, small numbers) for from-scratch training where HF ids are irrelevant.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

CLS, SEP, PAD, UNK = "[CLS]", "[SEP]", "[PAD]", "[UNK]"
MAX_LEN = 512  # ref: get_embedding.py:115


class WordPiece:
    """Greedy longest-match WordPiece with BERT's basic pre-tokenization
    specialized to numeric strings: split on whitespace, then split '-' off
    as its own token (BERT treats punctuation as separate tokens)."""

    def __init__(self, vocab: Dict[str, int], special: Optional[Dict[str, int]] = None):
        self.vocab = dict(vocab)
        sp = special or {}
        self.cls_id = sp.get(CLS, self.vocab.get(CLS, 101))
        self.sep_id = sp.get(SEP, self.vocab.get(SEP, 102))
        self.pad_id = sp.get(PAD, self.vocab.get(PAD, 0))
        self.unk_id = sp.get(UNK, self.vocab.get(UNK, 100))
        self._max_chars = max((len(k.lstrip("#")) for k in self.vocab), default=1)

    # -- core ---------------------------------------------------------------
    def wordpiece(self, word: str) -> List[int]:
        """Tokenize a single pre-split word (no whitespace)."""
        ids: List[int] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]  # HF marks the whole word UNK
            ids.append(cur)
            start = end
        return ids

    def pretokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for tok in text.split():
            # punctuation split (numeric strings only contain '-')
            while tok.startswith("-"):
                out.append("-")
                tok = tok[1:]
            if tok:
                out.append(tok)
        return out

    def encode(self, text: str, max_length: int = MAX_LEN):
        """[CLS] tokens [SEP], truncated + padded to max_length
        (ref: get_embedding.py:115 padding='max_length')."""
        ids = [self.cls_id]
        for w in self.pretokenize(text):
            ids.extend(self.wordpiece(w))
        ids = ids[: max_length - 1]
        ids.append(self.sep_id)
        mask = [1] * len(ids)
        while len(ids) < max_length:
            ids.append(self.pad_id)
            mask.append(0)
        return np.asarray(ids, np.int32), np.asarray(mask, np.int32)

    def encode_batch(self, texts: Sequence[str], max_length: int = MAX_LEN):
        pairs = [self.encode(t, max_length) for t in texts]
        return (
            np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]),
        )

    # -- persistence ----------------------------------------------------------
    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {
                    "vocab": self.vocab,
                    "special": {
                        CLS: self.cls_id,
                        SEP: self.sep_id,
                        PAD: self.pad_id,
                        UNK: self.unk_id,
                    },
                },
                f,
            )

    @staticmethod
    def load(path: str) -> "WordPiece":
        with open(path) as f:
            d = json.load(f)
        return WordPiece(d["vocab"], d.get("special"))

    @staticmethod
    def from_vocab_txt(path: str) -> "WordPiece":
        """Load a standard HF vocab.txt (one token per line, id = line no)."""
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return WordPiece(vocab)


def serialize_row(values) -> str:
    """CSV row -> space-joined string of values (ref: get_embedding.py:114)."""
    return " ".join(str(v) for v in values)


def default_tokenizer_for_coef(coef: str) -> "WordPiece":
    """Best-available tokenizer for an HF coef name, fully offline.

    - ``bert-base-uncased``: the packaged recovered vocab — exact HF token
      ids reconstructed from the reference's committed test artifacts
      (tools/recover_vocab.py; 601/601 rows byte-exact).
    - ``bert-base-cased`` (or anything else): the synthetic numeric vocab.
      No cased artifact is committed in the reference, so exact cased ids
      require a user-supplied vocab.txt (``WordPiece.from_vocab_txt``, wired
      through GetEmbedding(vocab_txts=...)); see PARITY.md.
    """
    import os

    if "uncased" in coef:
        path = os.path.join(os.path.dirname(__file__), "recovered_vocab_uncased.json")
        if os.path.exists(path):
            return RecoveredWordPiece.load(path)
    return synthetic_numeric_vocab()


def synthetic_numeric_vocab() -> WordPiece:
    """Deterministic self-contained vocab: specials, digits, '-', and all
    2-digit pieces; tokenizes any integer string without UNK. Used when no
    HF vocab / recovered vocab is available (from-scratch training)."""
    vocab = {PAD: 0, UNK: 100, CLS: 101, SEP: 102}
    next_id = 1000
    for d in "0123456789":
        vocab[d] = next_id
        next_id += 1
        vocab["##" + d] = next_id
        next_id += 1
    vocab["-"] = next_id
    next_id += 1
    for a in "0123456789":
        for b in "0123456789":
            vocab[a + b] = next_id
            next_id += 1
            vocab["##" + a + b] = next_id
            next_id += 1
    return WordPiece(vocab)


class RecoveredWordPiece(WordPiece):
    """WordPiece with an exact word->ids memo layered over greedy matching.

    Observed words reproduce their recorded HF id sequences verbatim; unseen
    words fall back to greedy longest-match over the recovered piece vocab.
    """

    def __init__(self, vocab, special, word_memo: Dict[str, tuple]):
        super().__init__(vocab, special)
        self.word_memo = dict(word_memo)

    def wordpiece(self, word: str) -> List[int]:
        memo = self.word_memo.get(word)
        if memo is not None:
            return list(memo)
        return super().wordpiece(word)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {
                    "vocab": self.vocab,
                    "special": {CLS: self.cls_id, SEP: self.sep_id,
                                PAD: self.pad_id, UNK: self.unk_id},
                    "word_memo": {k: list(v) for k, v in self.word_memo.items()},
                },
                f,
            )

    @staticmethod
    def load(path: str) -> "RecoveredWordPiece":
        with open(path) as f:
            d = json.load(f)
        return RecoveredWordPiece(
            d["vocab"], d.get("special"),
            {k: tuple(v) for k, v in d.get("word_memo", {}).items()},
        )


def recover_numeric_vocab(
    csv_texts: Sequence[str], tokenized_ids, base: Optional[WordPiece] = None
) -> RecoveredWordPiece:
    """Reconstruct the numeric WordPiece vocab from (text, HF-ids) pairs.

    ``csv_texts[i]`` must be the exact serialized string whose HF encoding is
    ``tokenized_ids[i]`` (512-long, incl. [CLS]/[SEP]/padding) — e.g. the
    reference's committed feature/test_EEG.csv + feature/EEG/test_bert.pickle.

    Fixpoint alignment: rows whose remaining words are all 'known' pin down
    the id run of a single unknown word (scanning from both ends); known
    surfaces then yield piece entries ('##'-continuations from multi-piece
    words). Observed words are additionally memoized verbatim, so encode()
    reproduces HF exactly on all observed rows regardless of how much of the
    piece inventory was identifiable.
    """
    helper = base or synthetic_numeric_vocab()
    rows = []
    cls_id = sep_id = pad_id = None
    for text, ids in zip(csv_texts, tokenized_ids):
        ids = [int(t) for t in ids]
        if cls_id is None:
            cls_id = ids[0]
            pad_id = ids[-1] if ids[-1] != ids[-2] or ids.count(ids[-1]) > 2 else 0
        # body: strip CLS, then strip trailing pad run, then SEP
        body = ids[1:]
        k = len(body)
        while k > 0 and body[k - 1] == body[-1] and len(set(body[k - 1 :])) == 1:
            k -= 1
        # body[-1] repeated == pad (or sep when no padding); body[k-1.. ] is
        # the trailing run; sep is the id right before it unless run is sep
        if k == 0:
            continue
        pad_run = body[k:]
        pad_id = pad_run[0] if pad_run else pad_id
        sep_id = body[k - 1]
        body = body[: k - 1]
        rows.append((helper.pretokenize(text), body))

    # -- phase 1: solve per-word piece counts by interval propagation --------
    # L(w) in [1, len(w)] (each piece covers >= 1 char); every row gives the
    # linear constraint sum_i L(word_i) = len(body). Iterating the interval
    # tightening over all rows pins down nearly every word's piece count.
    lo: Dict[str, int] = {}
    hi: Dict[str, int] = {}
    for words, body in rows:
        for w in words:
            lo.setdefault(w, 1)
            hi.setdefault(w, len(w))
    changed = True
    while changed:
        changed = False
        for words, body in rows:
            total = len(body)
            counts: Dict[str, int] = {}
            for w in words:
                counts[w] = counts.get(w, 0) + 1
            sum_lo = sum(lo[w] * c for w, c in counts.items())
            sum_hi = sum(hi[w] * c for w, c in counts.items())
            if not (sum_lo <= total <= sum_hi):
                continue  # inconsistent row (shouldn't happen); skip
            for w, c in counts.items():
                new_hi = (total - (sum_lo - c * lo[w])) // c
                new_lo = -((-(total - (sum_hi - c * hi[w]))) // c)
                if new_hi < hi[w]:
                    hi[w] = max(new_hi, lo[w])
                    changed = True
                if new_lo > lo[w]:
                    lo[w] = min(new_lo, hi[w])
                    changed = True

    # -- phase 2: per-row forward/backward feasibility DP --------------------
    # forward[i] = feasible positions after consuming words[:i];
    # backward[i] = positions from which words[i:] can exactly reach the end.
    # A word occurrence whose (position, length) choice is unique across all
    # feasible segmentations is learned. Known words must match their run
    # verbatim — a strong id-level pruning that rapidly collapses ambiguity
    # as the map grows. Iterate to fixpoint.
    word_map: Dict[str, tuple] = {}

    def options(w, p, body):
        """Feasible (piece-count, run) choices for word w at position p."""
        if w in word_map:
            run = word_map[w]
            if tuple(body[p : p + len(run)]) == run:
                return [len(run)]
            return []
        return [L for L in range(lo[w], hi[w] + 1) if p + L <= len(body)]

    def feasible(words, body):
        """Can words[:] consume body[:] exactly under current constraints?"""
        n, m = len(words), len(body)
        forward = {0}
        for w in words:
            nxt = set()
            for p in forward:
                for L in options(w, p, body):
                    nxt.add(p + L)
            forward = nxt
            if not forward:
                return False
        return m in forward

    def fixpoint():
        changed = True
        any_learned = False
        while changed:
            changed = False
            for words, body in rows:
                n, m = len(words), len(body)
                forward = [set() for _ in range(n + 1)]
                forward[0].add(0)
                for i, w in enumerate(words):
                    for p in forward[i]:
                        for L in options(w, p, body):
                            forward[i + 1].add(p + L)
                if m not in forward[n]:
                    continue  # inconsistent (shouldn't happen)
                backward = [set() for _ in range(n + 1)]
                backward[n].add(m)
                for i in range(n - 1, -1, -1):
                    w = words[i]
                    for p in range(m + 1):
                        for L in options(w, p, body):
                            if p + L in backward[i + 1]:
                                backward[i].add(p)
                                break
                for i, w in enumerate(words):
                    if w in word_map:
                        continue
                    cands = set()
                    for p in forward[i]:
                        if p not in backward[i]:
                            continue
                        for L in options(w, p, body):
                            if p + L in backward[i + 1]:
                                cands.add((p, L))
                    runs = {tuple(body[p : p + L]) for p, L in cands}
                    if len(runs) == 1 and cands:
                        word_map[w] = next(iter(runs))
                        changed = True
                        any_learned = True
        return any_learned

    fixpoint()

    # -- phase 3: derive piece surfaces from resolved words ------------------
    vocab: Dict[str, int] = {}
    id_surface: Dict[int, str] = {}

    def derive_pieces():
        for w, run in word_map.items():
            if len(run) == 1:
                vocab.setdefault(w, run[0])
                id_surface.setdefault(run[0], w)
        changed = True
        while changed:
            changed = False
            for w, run in word_map.items():
                if len(run) < 2:
                    continue
                first = id_surface.get(run[0])
                if first is None or first.startswith("##") or not w.startswith(first):
                    continue
                rest = w[len(first):]
                remaining = run[1:]
                while remaining:
                    if len(remaining) == 1:
                        piece = "##" + rest
                        if piece not in vocab:
                            vocab[piece] = remaining[0]
                            id_surface.setdefault(remaining[0], piece)
                            changed = True
                        break
                    cont = id_surface.get(remaining[0])
                    if cont is None or not cont.startswith("##"):
                        break
                    surf = cont[2:]
                    if not rest.startswith(surf):
                        break
                    rest = rest[len(surf):]
                    remaining = remaining[1:]

    derive_pieces()

    special = {CLS: cls_id, SEP: sep_id, PAD: pad_id if pad_id is not None else 0, UNK: 100}

    # -- phase 4: greedy tie-break for residual ambiguous words --------------
    # Tokenize each unresolved word greedily with the recovered piece vocab;
    # accept the prediction if every row containing the word remains exactly
    # segmentable. Re-derive pieces and repeat while progress is made.
    all_words = {w for words, _ in rows for w in words}
    occurrences: Dict[str, list] = {}
    for words, body in rows:
        for w in set(words):
            occurrences.setdefault(w, []).append((words, body))
    progress = True
    while progress:
        progress = False
        tmp = WordPiece(vocab, special)
        # deterministic order: sets iterate in hash order (randomized per
        # process), and which word is tried first decides how residual
        # ambiguity resolves — sort ties lexicographically
        for w in sorted(all_words - set(word_map), key=lambda s: (len(s), s)):
            pred = tuple(tmp.wordpiece(w))
            if pred == (tmp.unk_id,):
                continue
            word_map[w] = pred
            if all(feasible(ws, bd) for ws, bd in occurrences[w]):
                progress = True
            else:
                del word_map[w]
        if progress:
            fixpoint()
            derive_pieces()

    # -- phase 5: resolve stragglers to any globally-feasible run ------------
    for w in sorted(all_words - set(word_map), key=lambda s: (len(s), s)):
        words, body = occurrences[w][0]
        i = words.index(w)
        # candidate runs at this occurrence
        tried = set()
        for p in range(len(body)):
            for L in range(lo[w], hi[w] + 1):
                run = tuple(body[p : p + L])
                if run in tried or p + L > len(body):
                    continue
                tried.add(run)
                word_map[w] = run
                if all(feasible(ws, bd) for ws, bd in occurrences[w]):
                    break
                del word_map[w]
            if w in word_map:
                break
    fixpoint()
    derive_pieces()

    return RecoveredWordPiece(vocab, special, word_map)
