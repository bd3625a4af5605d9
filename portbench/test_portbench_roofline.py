"""The kernels' bounds on tables counted by hand."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import roofline
from portbench.reference.grouping import group_bucket

ADJ = {"strategy": "adjacency", "max_hamming": 1, "count_ratio": 2}


def test_segment_gemm_bytes_and_adds():
    # 6 live rows of 5 columns read once, 2 x 4 ids, 2 x 3 x 5 outputs
    need = 6 * 5 * 4 + 2 * 4 * 4 + 2 * 3 * 5 * 4
    assert need == 272
    assert roofline.segment_gemm_seconds(2, 4, 3, 5, 6) == pytest.approx(
        max(need / 3.35e12, 30 / 67e12))
    assert roofline.ssc_columns(150, fit=True) == 601
    assert roofline.ssc_columns(150, fit=False) == 751


def test_cluster_counts_and_bound():
    codes = {"AAAAAA": [0] * 6, "AAAAAC": [0] * 5 + [1], "CCCCCC": [1] * 6}
    # position 10: AAAAAA x3, AAAAAC x1, CCCCCC x2; position 20: AAAAAA x1
    umis = ["AAAAAA"] * 3 + ["AAAAAC"] + ["CCCCCC"] * 2 + ["AAAAAA"]
    pos = np.array([10] * 6 + [20])
    umi = np.array([codes[u] for u in umis], np.uint8)
    g = group_bucket(pos, umi, ADJ)
    # 3 unique at 10 (3 pairs), 1 at 20; one edge AAAAAA -> AAAAAC
    # (3 >= 2 * 1 - 1), none back (1 < 2 * 3 - 1); molecules: 2 at 10
    assert (g["unique"], g["pairs"], g["edges"], g["mol_pairs"]) == (4, 3, 1, 1)
    assert len(set(g["molecule"][:4])) == 1 and len(set(g["molecule"])) == 3
    # the 4 filled slots of one bucket's table (its padding not counted):
    # word, position, count read; seed, molecule id written; one count
    need = 4 * 3 * 4 + 2 * 4 * 4 + 4
    ops = 3 * (6 + 4) + 1 * 2 + 1 + 3 * 4
    assert (need, ops) == (84, 45)
    assert roofline.cluster_seconds(1, 1, 3, 1, 1, 4) == pytest.approx(
        max(need / 3.35e12, ops / roofline.I32_OPS))
    assert roofline.umi_words(12) == 1 and roofline.umi_words(16) == 2


def test_trace_reduction():
    from torch.autograd import DeviceType

    from portbench.lib.trace import Trace, _reduce

    class Ev:
        def __init__(self, name, dev, s, e):
            self.n, self.d, self.s, self.e = name, dev, s, e

        def name(self):
            return self.n

        def device_type(self):
            return self.d

        def start_ns(self):
            return self.s

        def end_ns(self):
            return self.e

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    evs = [Ev("k1", cuda, 100, 200), Ev("k2", cuda, 150, 300), Ev("k1", cuda, 1000, 1100),
           Ev("launch", cpu, 0, 50), Ev("cudaGraphLaunch", cpu, 900, 1000)]
    tr = Trace()
    _reduce(evs, tr)
    assert tr.intervals == [(100, 300), (1000, 1100)]
    assert tr.busy_s == pytest.approx(300e-9)
    assert tr.kernel_seconds("k1") == (pytest.approx(200e-9), 2)
    assert tr.idle_gaps[0] == ["cudaGraphLaunch", pytest.approx(700e-9)]
    assert tr.breakdown()["device_ops"][0][0] in ("k1", "k2")
