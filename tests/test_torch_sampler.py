"""Temperature sampling in the port (``repro_torch/serve/sampler.py``).

JAX's PRNG cannot be matched bit for bit, so the port is held to its own
contract instead: ``temperature <= 0`` is exactly the greedy argmax; the
integer hash is splitmix64's, bit for bit (checked against Python's
unbounded integers); a seeded request's tokens do not depend on its
batch-mates, its row or the engine's seed; and the draws follow
softmax(logits / T), independently across rows and across a row's tokens
(chi-square tests at significance 0.001, on fixed keys, so each outcome is
deterministic).
"""

import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch.configs import reduced_config
from repro_torch.models import LM
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.sampler import (
    fold_in,
    fold_key_grid,
    greedy_sample,
    mix64,
    request_key,
    temperature_sample,
    uniform_bits,
)

ALPHA = 1e-3                 # significance of every distribution test
M64 = (1 << 64) - 1


def _py_mix(x: int) -> int:
    x &= M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def _signed(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


def test_mix64_is_splitmix64_bit_for_bit():
    rng = np.random.default_rng(0)
    xs = [int(v) for v in rng.integers(0, 1 << 63, 2000, dtype=np.uint64)]
    xs += [0, 1, M64, 1 << 63, (1 << 63) - 1] + [x | (1 << 63) for x in xs]
    got = mix64(torch.tensor([_signed(x) for x in xs], dtype=torch.int64))
    assert [int(v) & M64 for v in got] == [_py_mix(x) for x in xs]


def test_uniforms_lie_inside_the_open_interval():
    u = uniform_bits(torch.tensor([0, -1, 12345], dtype=torch.int64), 50000)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01


def test_fold_key_grid_is_fold_in_per_token_index():
    keys = torch.tensor([3, -7, 1 << 40], dtype=torch.int64)
    offsets = torch.tensor([0, 1, 5], dtype=torch.int64)
    grid = fold_key_grid(keys, offsets, 4)
    for s in range(4):
        assert torch.equal(grid[s], fold_in(keys, offsets + s))
        assert torch.equal(grid[s, 0], fold_in(keys[0], s))


@pytest.mark.parametrize("t", [0.0, -0.5])
def test_nonpositive_temperature_is_greedy_exactly(t):
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(6, 1, 33, generator=g)
    logits[1, 0, [4, 9]] = 10.0                    # a tie: the first index
    temps = torch.tensor([t, 1.0, t, 0.5, t, 2.0])
    keys = torch.arange(6, dtype=torch.int64) * 977
    got = temperature_sample(logits, keys, temps)
    want = greedy_sample(logits)
    rows = temps <= 0
    assert torch.equal(got[rows], want[rows])
    assert torch.equal(temperature_sample(logits, keys, t), want)
    assert int(greedy_sample(logits)[1]) == 4


def _draws(logits_row: torch.Tensor, T: float, keys: torch.Tensor):
    n = keys.shape[0]
    logits = logits_row.expand(n, 1, -1)
    return temperature_sample(logits, keys, T).ravel().numpy()


LOGITS = torch.tensor([[1.5, 0.2, -0.7, 0.9, 0.0, -2.0]])
N = 20000


@pytest.mark.parametrize("T", [0.7, 1.0, 2.5])
@pytest.mark.parametrize("stream", ["rows", "tokens"])
def test_frequencies_follow_softmax(T, stream):
    """Across rows (N distinct request keys, one token each) or along one
    row (one request key, N token indices): a chi-square goodness-of-fit
    test against softmax(logits / T) at significance ALPHA."""
    if stream == "rows":
        keys = torch.tensor([request_key(s, None) for s in range(N)])
    else:
        keys = fold_in(torch.tensor(request_key(11, None)),
                       torch.arange(N, dtype=torch.int64))
    toks = _draws(LOGITS, T, keys)
    counts = np.bincount(toks, minlength=LOGITS.shape[1])
    p = torch.softmax(LOGITS[0].double() / T, dim=0).numpy()
    assert stats.chisquare(counts, N * p).pvalue > ALPHA


def test_rows_are_independent():
    """Two rows drawn side by side (row keys of neighbouring seeds, as in
    one batch): a chi-square test of independence of their tokens at
    significance ALPHA, and no excess of equal pairs."""
    a = torch.tensor([request_key(2 * s, None) for s in range(N)])
    b = torch.tensor([request_key(2 * s + 1, None) for s in range(N)])
    ta, tb = _draws(LOGITS, 1.0, a), _draws(LOGITS, 1.0, b)
    V = LOGITS.shape[1]
    table = np.zeros((V, V))
    np.add.at(table, (ta, tb), 1)
    assert stats.chi2_contingency(table).pvalue > ALPHA
    p = torch.softmax(LOGITS[0].double(), dim=0).numpy()
    same = int((ta == tb).sum())
    assert stats.binomtest(same, N, float((p * p).sum())).pvalue > ALPHA


def test_request_key_is_a_function_of_the_seed_only():
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    assert request_key(42, g1) == request_key(42, g2) == request_key(42, None)
    assert request_key(42, None) != request_key(43, None)
    a = [request_key(None, torch.Generator().manual_seed(5)) for _ in range(2)]
    assert a[0] == a[1] != request_key(None, torch.Generator().manual_seed(6))


# ---------------------------------------------------------- through serving

CFG = reduced_config("qwen2-1.5b")
PLEN, MAX_NEW = 6, 8


@pytest.fixture(scope="module")
def model_params():
    model = LM(CFG, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _prompt(i):
    return torch.from_numpy(np.random.default_rng(100 + i).integers(
        0, CFG.vocab_size, PLEN))


def _serve(model_params, reqs, *, seed=0, batch=3):
    model, params = model_params
    engine = ServeEngine(model, params, batch_size=batch, max_seq_len=32,
                         seed=seed, device="cpu")
    return {r.uid: r.tokens for r in engine.generate(reqs)}


def test_seeded_request_reproduces_across_batches_and_engine_seeds(
        model_params):
    """Equal prompt lengths, so no batch-mate pads the seeded prompt."""
    seeded = Request(uid=0, prompt=_prompt(0), max_new_tokens=MAX_NEW,
                     temperature=0.9, seed=1234)
    alone = _serve(model_params, [seeded])[0]
    others = [Request(uid=1, prompt=_prompt(1), max_new_tokens=3),
              Request(uid=2, prompt=_prompt(2), max_new_tokens=MAX_NEW,
                      temperature=1.3)]
    mixed = _serve(model_params, others + [seeded])       # row 2 of 3
    reseeded = _serve(model_params, [others[1], seeded], seed=99)
    assert len(alone) == MAX_NEW
    assert mixed[0] == alone and reseeded[0] == alone
    # the unseeded row follows the engine's seed
    assert mixed[2] == _serve(model_params, others + [seeded])[2]
    assert mixed[2] != reseeded[2]
    # another seed is another stream
    other = Request(uid=0, prompt=_prompt(0), max_new_tokens=MAX_NEW,
                    temperature=0.9, seed=4321)
    assert _serve(model_params, [other])[0] != alone


def test_greedy_rows_of_a_temperature_chunk_are_greedy(model_params):
    reqs = [Request(uid=i, prompt=_prompt(i), max_new_tokens=MAX_NEW)
            for i in range(3)]
    greedy = _serve(model_params, reqs)
    mixed = _serve(model_params, [reqs[0], Request(
        uid=1, prompt=_prompt(1), max_new_tokens=MAX_NEW, temperature=5.0),
        Request(uid=2, prompt=_prompt(2), max_new_tokens=MAX_NEW,
                temperature=0.0)])
    assert mixed[0] == greedy[0] and mixed[2] == greedy[2]
    assert mixed[1] != greedy[1]
