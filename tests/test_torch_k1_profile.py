"""The K1 profile script (``tools/k1_profile.py``) on the CPU.

The profile runs only on a card; here its input generator is held to what
its description says, and its entry point must refuse to run without a
card.  It imports nothing of JAX or the JAX package.
"""

import numpy as np
import pytest
import torch

from lidar_object_detection_tpu_torch.ops.inside_counts import (
    inside_counts_plain)
from lidar_object_detection_tpu_torch.tools import k1_profile


def test_clustered_words_lie_only_inside_valid_boxes():
    rng = np.random.default_rng(3)
    pts, pvalid, corners, mask = k1_profile.make_inputs(
        torch, torch.device("cpu"), rng, 1)
    assert pts.shape == (1, 131072, 3) and int(mask.sum()) == 300
    words = torch.from_numpy(k1_profile.clustered_words(
        torch, rng, pts, pvalid, corners, mask))
    active = words != 0
    assert int(active.sum()) > 10000
    assert not bool((active & ~torch.from_numpy(pvalid)).any())
    # totals count every set bit of the words; since every active point
    # lies in a valid box, each detection has at least as many inside hits
    bits = np.unpackbits(words.numpy().view(np.uint8)).sum()
    counts, totals = inside_counts_plain(pts, words, corners, mask, 32)
    assert int(totals.sum()) == int(bits)
    assert bool((counts.sum(dim=2) >= totals).all())


def test_profile_refuses_to_run_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert k1_profile.main([]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
