"""The roofline byte counts on small shapes worked by hand."""

from benchmark import roofline


def test_walk_lookups_count_distinct_prefixes():
    assert roofline.walk_lookups([]) == 0
    assert roofline.walk_lookups(["a/+/c"]) == 3
    # a, a/+, a/+/c, a/b, a/b/#
    assert roofline.walk_lookups(["a/+/c", "a/b/#"]) == 5


def test_walk_bytes():
    # 3 words read (12 B), 5 edge lookups (40 B), 2 ids written (8 B)
    assert roofline.walk_bytes("a/b/c", ["a/+/c", "a/b/#"], 16) == 60
    # a topic that matches nothing still reads its words
    assert roofline.walk_bytes("x/y", [], 16) == 8
    # words past max_levels are not read by the walk
    assert roofline.walk_bytes("/".join("abcdef"), [], 4) == 16


def test_bitmap_bytes():
    assert roofline.bitmap_row_bytes(64) == 8
    assert roofline.bitmap_row_bytes(65) == 12
    # rows {w1, w2} read once, 2 union rows written: 4 rows of 8 B
    per = [["w1"], [], ["w1", "w2"]]
    assert roofline.bitmap_or_bytes(per, 64) == 32
    assert roofline.bitmap_or_bytes([[], []], 64) == 0


def test_roofline_pct():
    # 3.35 MB in 1 ms at 3.35 TB/s: 1 microsecond of 1 ms
    assert abs(roofline.roofline_pct(3.35e6, 1e-3) - 0.1) < 1e-12
    assert roofline.roofline_pct(1.0, 0.0) is None
    assert roofline.least_seconds(0, 67e12) == 1.0
