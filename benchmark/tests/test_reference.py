"""The plain reference on hand-worked cases."""

import subprocess
import sys
from pathlib import Path

from benchmark import reference
from benchmark.reference import Matcher, Reference

ROOT = Path(__file__).resolve().parents[2]


def test_plus_matches_one_level_including_empty():
    m = Matcher(["a/+/c", "+/b/c", "a/+"])
    assert sorted(m.match("a/b/c")) == ["+/b/c", "a/+/c"]
    assert m.match("a//c") == ["a/+/c"]
    assert m.match("a/") == ["a/+"]
    assert m.match("a/b/c/d") == []


def test_hash_matches_rest_and_parent():
    m = Matcher(["a/#", "#", "a/b/#"])
    assert sorted(m.match("a")) == ["#", "a/#"]
    assert sorted(m.match("a/b")) == ["#", "a/#", "a/b/#"]
    assert sorted(m.match("a/b/c/d")) == ["#", "a/#", "a/b/#"]
    assert m.match("b") == ["#"]


def test_dollar_topics_skip_root_wildcards():
    m = Matcher(["#", "+/x", "$SYS/#", "$SYS/+"])
    assert sorted(m.match("$SYS/x")) == ["$SYS/#", "$SYS/+"]
    assert sorted(m.match("s/x")) == ["#", "+/x"]


def test_mixed_wildcards():
    m = Matcher(["+/+/#", "a/+/#", "a/b"])
    assert sorted(m.match("a/b")) == ["+/+/#", "a/+/#", "a/b"]
    assert m.match("a") == []


def test_share_groups_and_counts():
    ref = Reference([(0, "a/+"), (1, "a/+"), (2, "$share/g/a/+"),
                     (3, "$share/g/a/+"), (4, "$share/h/a/#"), (0, "a/#")])
    need, groups, matched = ref.expect("a/b")
    assert need == {0: 2, 1: 1}
    assert sorted(map(sorted, groups)) == [[2, 3], [4]]
    assert sorted(matched) == ["a/#", "a/+"]


def _judge(dl, ack):
    ref = Reference([(0, "a/+"), (1, "$share/g/a/+"), (2, "$share/g/a/+")])
    got = {7: [(s, p) for s, p in dl]}
    acks = {7: ack} if ack is not None else {}
    return reference.judge(ref, {7: "a/b"}, acks, got)


def test_judge_clean():
    assert _judge([(0, 1), (2, 2)], (2, 3)) == {
        "lost": 0, "extra": 0, "share_wrong": 0, "ack_wrong": 0,
        "early_ack": 0}


def test_judge_faults():
    assert _judge([(2, 2)], (2, 3))["lost"] == 1
    out = _judge([(0, 1), (1, 2), (2, 3)], (3, 4))
    assert out["share_wrong"] == 1 and out["extra"] == 1
    assert _judge([(0, 1)], (1, 2))["share_wrong"] == 1
    assert _judge([(0, 1), (2, 2)], (3, 3))["ack_wrong"] == 1
    assert _judge([(0, 1), (2, 5)], (2, 3))["early_ack"] == 1
    assert _judge([(0, 1), (0, 2), (2, 3)], (2, 4))["extra"] == 1


def test_wide_filters():
    subs = [(i, "w") for i in range(5)] + [(9, "n")]
    assert Reference(subs).wide_filters(4) == ["w"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference, benchmark.roofline; "
            "print(sorted({m.partition('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"jax", "jaxlib", "flax", "emqx_tpu",
                       "emqx_tpu_torch", "torch", "numpy"}
