"""The port's data pipeline against the reference's, bit for bit.

`repro_torch.data` is a copy of `repro.data.pipeline` (numpy
``RandomState`` code): for the same config, shape and seed, every batch
array and every camera frame must be identical, dtype included.
"""
import numpy as np
import pytest

from repro import configs as jconfigs
from repro import data as jdata
from repro_torch import configs as tconfigs
from repro_torch import data as tdata


def _assert_batches_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCH_IDS))
@pytest.mark.parametrize("smoke", [True, False])
def test_make_batch_equals_reference(arch, smoke):
    """Every architecture's modality: text tokens, musicgen's (B, S, K)
    codebook lattice, llava's vision-prefix embeddings."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if smoke:
        jcfg, tcfg = jconfigs.smoke_variant(jcfg), tconfigs.smoke_variant(tcfg)
    seq = max(64, jcfg.vision_tokens + 8)
    for seed in (0, 5):
        _assert_batches_equal(tdata.make_batch(tcfg, tdata.BatchSpec(2, seq), seed=seed),
                              jdata.make_batch(jcfg, jdata.BatchSpec(2, seq), seed=seed))


def test_token_batches_equal_reference():
    jcfg = jconfigs.smoke_variant(jconfigs.get_config("musicgen-large"))
    tcfg = tconfigs.smoke_variant(tconfigs.get_config("musicgen-large"))
    got = list(tdata.token_batches(tcfg, tdata.BatchSpec(3, 16), seed=7, num_batches=4))
    want = list(jdata.token_batches(jcfg, jdata.BatchSpec(3, 16), seed=7, num_batches=4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_vision_prefix_needs_text_positions():
    cfg = tconfigs.smoke_variant(tconfigs.get_config("llava-next-mistral-7b"))
    with pytest.raises(ValueError):
        tdata.make_batch(cfg, tdata.BatchSpec(1, cfg.vision_tokens))


@pytest.mark.parametrize("width,height,seed", [(640, 480, 0), (64, 48, 3)])
def test_camera_frames_equal_reference(width, height, seed):
    got = list(tdata.camera_frames(width, height, seed=seed, num_frames=3))
    want = list(jdata.camera_frames(width, height, seed=seed, num_frames=3))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and g.shape == (height, width, 3)
        np.testing.assert_array_equal(g, w)
