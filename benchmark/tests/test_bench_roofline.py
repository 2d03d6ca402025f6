"""The roofline's count, worked by hand on two reads."""
import pytest

from benchmark import roofline


def test_two_reads_by_hand():
    # rows (ref + qry + 1) x 61 cells x 35 operations:
    # (100 + 90 + 1) * 61 * 35 + (50 + 60 + 1) * 61 * 35
    ops, nbytes = roofline.dp_work([(100, 90), (50, 60)])
    assert roofline.ops_per_cell(6) == 35
    assert ops == 191 * 61 * 35 + 111 * 61 * 35 == 644770
    # bases 190 + 110, CIGAR ops at least 100 + 60, tables 100 + 620,544
    assert roofline.table_bytes(6) == 100 + 2 * 6 * 101 * 128 * 4
    assert nbytes == 300 + 160 + 620644
    t, by = roofline.least_time(ops, nbytes)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
