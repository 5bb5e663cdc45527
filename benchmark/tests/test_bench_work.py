"""Byte counts against shapes, and the roofline share."""
import pytest

from harness import work


def test_k1_bytes_at_the_cells_shape():
    # 1,024 rows of 65,536 bases, 512-base chunks of 12 slots
    assert work.k1_bytes(1024, 65536, 512, 12) == (
        1024 * 65536 + 8 * 1024 + 1024 * 128 * 12 / 8)


def test_k7_and_k8_bytes_grow_with_anchors_only_where_valid():
    B, Pc, C, M = 1024, 192, 94, 3
    G, N = B * C, Pc * M
    empty7 = work.k7_bytes(B, Pc, G, N, 0, 0)
    assert empty7 == pytest.approx(B * Pc * 16.25 + G * N / 8
                                   + (B + G) / 8 + 8)
    assert work.k7_bytes(B, Pc, G, N, 1000, 10) - empty7 == pytest.approx(
        1000 * work.ANCHOR + 10 * work.POSTING)
    assert work.k8_bytes(G, N, 0) == pytest.approx(G * N / 8 + 2 * G / 8)
    assert work.k8_bytes(G, N, 1) - work.k8_bytes(G, N, 0) == (
        pytest.approx(work.ANCHOR + work.SCORE))


def test_roofline_pct():
    assert work.roofline_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert work.roofline_pct(3.35e9, 0.002) == pytest.approx(50.0)
