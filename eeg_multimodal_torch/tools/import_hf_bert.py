"""Convert an on-disk HF BERT checkpoint to the port's BERT tree.

    python -m eeg_multimodal_torch.tools.import_hf_bert <hf_dir_or_state_dict> \\
        out_params.pickle [--vocab out_vocab.json] [--prefix bert.]

The port of the JAX package's ``tools/import_hf_bert.py``. A user migrating
from the reference typically has ``bert-base-uncased`` on disk
(``pytorch_model.bin`` or ``model.safetensors`` beside ``vocab.txt``). This
tool converts

  - the state dict -> the port's BERT tree, written by
    ``train/checkpoint.py::save_pytree`` (the port's format), which
    ``Trainer(..., bert_params=load_pytree(path))`` takes as the reference's
    ``BertModel.from_pretrained`` init (models.py:40);
  - ``vocab.txt`` -> a WordPiece JSON for ``data/tokenizer.py`` (exact HF
    token ids).

Host-only: it reads and writes files on the CPU and takes no device.
``.safetensors`` files are read by :func:`read_safetensors`, this module's
own reader of the format, so no ``safetensors`` package is needed.
"""
import argparse
import json
import os
import pickle
import struct

import numpy as np
import torch

from ..data.tokenizer import WordPiece
from ..models import bert as B
from ..train.checkpoint import normalize_torch_keys, save_pytree

# the format's dtype names -> torch dtypes (little-endian bytes)
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path):
    """The tensors of a ``.safetensors`` file, by name, as CPU tensors.

    The format: an 8-byte little-endian header length N, N bytes of JSON
    mapping each name to its ``dtype``, ``shape`` and ``data_offsets``
    ([begin, end) into the byte buffer that follows the header; an optional
    ``__metadata__`` entry holds strings), then the buffer, each tensor's
    bytes little-endian and row-major."""
    with open(path, "rb") as f:
        raw = f.read()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    buf = bytearray(raw[8 + n:])  # writable, so torch.frombuffer shares it
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which this reader "
                             f"does not read ({sorted(SAFETENSORS_DTYPES)})")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize:
            raise ValueError(f"{path}: {name} holds {end - begin} bytes for {shape} "
                             f"{info['dtype']}")
        t = torch.frombuffer(buf, dtype=dtype, count=count, offset=begin) if count else \
            torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def load_state_dict(path):
    """The state dict at ``path``: a directory's ``pytorch_model.bin``, else
    its ``model.safetensors``; a ``.safetensors`` file through
    :func:`read_safetensors`; any other file through ``pickle.load``, then
    ``torch.load(map_location="cpu")``, as the JAX tool reads it."""
    if os.path.isdir(path):
        for name in ("pytorch_model.bin", "model.safetensors"):
            p = os.path.join(path, name)
            if os.path.exists(p):
                path = p
                break
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:
        return torch.load(path, map_location="cpu")


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("src", help="HF dir or state-dict file")
    ap.add_argument("out", help="output params pickle")
    ap.add_argument("--vocab", help="also write WordPiece json from vocab.txt")
    ap.add_argument("--prefix", default="", help="key prefix (e.g. 'bert.')")
    return ap


def main(argv=None):
    """Convert; returns the tree written (f32 CPU tensors)."""
    args = parser().parse_args(argv)
    sd = normalize_torch_keys(load_state_dict(args.src))
    vocab_size = None
    for k in sd:
        if k.endswith("word_embeddings.weight"):
            vocab_size = sd[k].shape[0]
            break
    cfg = B.BertConfig(vocab_size=int(vocab_size)) if vocab_size else B.BertConfig()
    params = B.from_torch_state_dict(sd, cfg, prefix=args.prefix, device="cpu")
    save_pytree(args.out, params)
    print(f"wrote {args.out} (vocab_size={cfg.vocab_size})")

    if args.vocab:
        vocab_txt = os.path.join(args.src, "vocab.txt") if os.path.isdir(args.src) else None
        if not vocab_txt or not os.path.exists(vocab_txt):
            raise SystemExit("--vocab requires vocab.txt next to the checkpoint")
        WordPiece.from_vocab_txt(vocab_txt).save(args.vocab)
        print(f"wrote {args.vocab}")
    return params


if __name__ == "__main__":
    main()
