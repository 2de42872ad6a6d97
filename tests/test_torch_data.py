"""The port's data pipeline (``repro_torch.data``, a framework-free copy)
against the JAX reference's, on the CPU: ``SyntheticLM`` batches equal
bit for bit (tokens, masked labels, patch embeddings, frames), across
host shards, and the ``Prefetcher``'s order."""

import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.data import pipeline as ref_pipeline
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, Prefetcher, SyntheticLM

ARCHS = ["gpt2-medium", "internvl2-1b", "whisper-large-v3", "mamba2-780m"]


def _pair(arch, **dc):
    rcfg, cfg = ref_get_config(arch).smoke(), get_config(arch).smoke()
    return (ref_pipeline.SyntheticLM(rcfg, ref_pipeline.DataConfig(**dc)),
            SyntheticLM(cfg, DataConfig(**dc)))


def _equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_equal_the_reference_bit_for_bit(arch):
    ref, ours = _pair(arch, seq_len=64, global_batch=4, seed=3,
                      mean_doc_len=16)
    for step in (0, 1, 17):
        _equal(ours.batch(step), ref.batch(step))
    b = ours.batch(0)
    assert (b["labels"] == -100).any()           # masked doc boundaries


@pytest.mark.parametrize("hosts", [2, 4])
def test_host_shards_equal_the_reference_and_tile_the_global_batch(hosts):
    _, whole = _pair("gpt2-medium", seq_len=32, global_batch=4, seed=1)
    shards = []
    for h in range(hosts):
        ref, ours = _pair("gpt2-medium", seq_len=32, global_batch=4, seed=1,
                          num_hosts=hosts, host_index=h)
        got = ours.batch(5)
        _equal(got, ref.batch(5))
        shards.append(got["tokens"])
    np.testing.assert_array_equal(np.concatenate(shards),
                                  whole.batch(5)["tokens"])


def test_prefetcher_yields_steps_in_order_and_closes():
    _, ours = _pair("gpt2-medium", seq_len=16, global_batch=2, seed=0)
    pf = Prefetcher(ours, start_step=3, depth=2)
    got = [pf.next() for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for s, b in got:
        _equal(b, ours.batch(s))
    assert not pf._thread.is_alive()
