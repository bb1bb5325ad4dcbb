"""The port's copy of the data pipeline against the reference's: the
same batches, bit for bit, from the same seeds and steps, and a loader
that resumes by step."""
import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe

CONFIGS = [dict(vocab_size=128, seq_len=32, global_batch=8),
           dict(vocab_size=512, seq_len=64, global_batch=16, seed=3),
           dict(vocab_size=163840, seq_len=16, global_batch=4, n_hosts=2,
                vision_frac_mean=0.3, vision_frac_std=0.5)]


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("step", [0, 7])
def test_lm_batch_bitwise(cfg, step):
    for host in range(cfg.get("n_hosts", 1)):
        _equal(tpipe.lm_batch(tpipe.DataConfig(**cfg), step, host),
               jpipe.lm_batch(jpipe.DataConfig(**cfg), step, host))


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("d_model", [0, 16])
def test_multimodal_batch_bitwise(cfg, d_model):
    for step in (0, 5):
        _equal(tpipe.multimodal_batch(tpipe.DataConfig(**cfg), step,
                                      d_model=d_model),
               jpipe.multimodal_batch(jpipe.DataConfig(**cfg), step,
                                      d_model=d_model))


@pytest.mark.parametrize("multimodal", [False, True])
def test_loader_resume_bitwise(multimodal):
    """A loader started at step 3 yields what the reference's loader yields
    after three batches, and so does the port's own."""
    cfg = CONFIGS[1]
    kw = dict(multimodal=multimodal, d_model=8 if multimodal else 0)
    ref = jpipe.DataLoader(jpipe.DataConfig(**cfg), **kw)
    mine = tpipe.DataLoader(tpipe.DataConfig(**cfg), **kw)
    for _ in range(3):
        _equal(next(mine), next(ref))
    resumed = tpipe.DataLoader(tpipe.DataConfig(**cfg), start_step=3, **kw)
    for _ in range(2):
        want = next(ref)
        _equal(next(resumed), want)
        _equal(next(mine), want)
