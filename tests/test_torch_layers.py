"""The port's layers and BERT (models/layers.py, models/bert.py) against the
JAX package, on one weight set made by the JAX initializers and carried
across as numpy. Dropout is compared with the rate at 0 or statistically.
Tolerance: rtol 1e-5 / atol 1e-5 (f32 forward, one layer at a time)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_multimodal_tpu.models import bert as JB
from eeg_multimodal_tpu.models import layers as JL
from eeg_multimodal_torch.models import bert as TB
from eeg_multimodal_torch.models import layers as TL
from eeg_multimodal_torch.utils.trees import tree_items, tree_map

FWD = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work. The suite runs
    several test processes on the same cores, where torch's default of a
    thread per core makes small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def x_of(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or FWD))


def test_linear_and_layer_norm():
    lin = JL.linear_init(jax.random.PRNGKey(0), 48, 24)
    x = x_of(3, 5, 48)
    close(TL.linear(to_torch(lin), torch.from_numpy(x)), JL.linear(lin, jnp.asarray(x)))
    ln = {"scale": x_of(48, seed=1), "bias": x_of(48, seed=2)}
    close(TL.layer_norm(to_torch(ln), torch.from_numpy(x)), JL.layer_norm(ln, jnp.asarray(x)))


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention(masked):
    p = JL.mha_init(jax.random.PRNGKey(1), 32)
    q, kv = x_of(2, 3, 32, seed=3), x_of(2, 6, 32, seed=4)
    mask = np.zeros((2, 6), bool)
    if masked:
        mask[0, 4:] = True
        mask[1, 1] = True
    want = JL.multi_head_attention(p, jnp.asarray(q), jnp.asarray(kv), 4,
                                   key_padding_mask=jnp.asarray(mask))
    got = TL.multi_head_attention(to_torch(p), torch.from_numpy(q), torch.from_numpy(kv), 4,
                                  key_padding_mask=torch.from_numpy(mask))
    close(got, want)


def test_decoder_layers_with_dropout_off():
    p = JL.decoder_init(jax.random.PRNGKey(2), 32, 3)
    tgt, mem = x_of(2, 1, 32, seed=5), x_of(2, 7, 32, seed=6)
    tmask = np.zeros((2, 1), bool)
    mmask = np.zeros((2, 7), bool)
    mmask[1, 5:] = True
    tp = to_torch(p)
    got_layer = TL.decoder_layer(tp["layers"][0], torch.from_numpy(tgt), torch.from_numpy(mem), 4,
                                 torch.from_numpy(tmask), torch.from_numpy(mmask))
    want_layer = JL.decoder_layer(p["layers"][0], jnp.asarray(tgt), jnp.asarray(mem), 4,
                                  jnp.asarray(tmask), jnp.asarray(mmask))
    close(got_layer, want_layer)
    got = TL.decoder(tp, torch.from_numpy(tgt), torch.from_numpy(mem), 4,
                     torch.from_numpy(tmask), torch.from_numpy(mmask))
    want = JL.decoder(p, jnp.asarray(tgt), jnp.asarray(mem), 4, jnp.asarray(tmask),
                      jnp.asarray(mmask))
    close(got, want, rtol=1e-4, atol=1e-5)


def test_decoder_init_layers_start_identical_and_apart():
    p = TL.decoder_init(torch.Generator().manual_seed(0), 16, 3, "cpu")
    a, b = (dict(tree_items(layer)) for layer in p["layers"][:2])
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]) and a[k].data_ptr() != b[k].data_ptr()


def test_dropout_is_inverted_and_keeps_the_rate():
    x = torch.ones(200_000)
    assert TL.dropout(x, 0.0, torch.Generator()) is x
    assert TL.dropout(x, 0.1, None) is x
    y = TL.dropout(x, 0.1, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))


SMALL_BERT = dict(vocab_size=50, hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128, max_position_embeddings=16)


def bert_inputs():
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 50, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.int32)
    mask[1, 6:] = 0
    mask[2, 3:] = 0
    return ids, mask


@pytest.mark.parametrize("num_layers", [1, 2])
def test_bert_matches_jax_with_dropout_off(num_layers):
    jc = JB.BertConfig(**{**SMALL_BERT, "num_layers": num_layers})
    tc = TB.BertConfig(**{**SMALL_BERT, "num_layers": num_layers})
    p = JB.init(jax.random.PRNGKey(4), jc)
    ids, mask = bert_inputs()
    seq_j, pooled_j = JB.apply(p, jnp.asarray(ids), jnp.asarray(mask), jc)
    seq_t, pooled_t = TB.apply(to_torch(p), torch.from_numpy(ids).long(),
                               torch.from_numpy(mask).long(), tc)
    tol = FWD if num_layers == 1 else dict(rtol=1e-4, atol=1e-5)
    close(seq_t, seq_j, **tol)
    close(pooled_t, pooled_j, **tol)


def test_bert_init_has_the_jax_tree():
    jc = JB.BertConfig(**SMALL_BERT)
    want = {k: v.shape for k, v in tree_items(jax.tree_util.tree_map(np.asarray, JB.init(
        jax.random.PRNGKey(0), jc)))}
    got = {k: tuple(v.shape) for k, v in tree_items(TB.init(
        torch.Generator().manual_seed(0), TB.BertConfig(**SMALL_BERT), "cpu"))}
    assert got == want
