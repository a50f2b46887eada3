"""The port's host utilities (``emqx_tpu_torch.utils.sequence``,
``.pmon``, ``.misc``) against the JAX package's.

Each case of ``tests/test_utils.py`` for these three modules runs the
same operations on the JAX object and on the port's, keeps the
original test's assertions, and the two must return the same values
at every step.
"""

import asyncio

from emqx_tpu.utils import misc as jmisc
from emqx_tpu.utils.pmon import PMon as JPMon
from emqx_tpu.utils.sequence import Sequence as JSequence
from emqx_tpu_torch.utils import misc as pmisc
from emqx_tpu_torch.utils.pmon import PMon as PPMon
from emqx_tpu_torch.utils.sequence import Sequence as PSequence


def _both(scenario, *pairs):
    """``scenario`` on the JAX objects, then on the port's: equal."""
    want = scenario(*[p[0] for p in pairs])
    got = scenario(*[p[1] for p in pairs])
    assert got == want
    return got


# -- sequence ---------------------------------------------------------------

def _sequence(Sequence):
    s = Sequence()
    out = [s.nextval("t"), s.nextval("t"), s.nextval("u"), s.currval("t"),
           s.reclaim("t"), s.reclaim("t"), s.currval("t"),
           s.reclaim("ghost")]
    assert out == [1, 2, 1, 2, 1, 0, 0, 0]
    return out


def test_sequence_nextval_reclaim():
    _both(_sequence, (JSequence, PSequence))


# -- pmon -------------------------------------------------------------------

def _pmon_explicit(PMon):
    pm = PMon()
    pm.monitor("a", {"x": 1})
    pm.monitor("b", {"x": 2})
    assert pm.count() == 2 and pm.find("a") == {"x": 1} and "a" in pm
    pm.notify_down("a")
    pm.notify_down("ghost")  # unknown: ignored
    erased = pm.erase_all()
    assert erased == [("a", {"x": 1})]
    assert pm.count() == 1 and "a" not in pm
    pm.demonitor("b")
    assert pm.count() == 0
    return erased


def test_pmon_explicit_down_batch_erase():
    _both(_pmon_explicit, (JPMon, PPMon))


def _pmon_task(PMon):
    async def go():
        pm = PMon()

        async def short():
            return 42

        t = asyncio.get_running_loop().create_task(short())
        pm.monitor("conn1", "val", task=t)
        # a stale generation: re-registered before the task ends, so
        # its completion must not queue the new entry
        t2 = asyncio.get_running_loop().create_task(short())
        pm.monitor("conn2", "old", task=t2)
        pm.monitor("conn2", "new")
        await t
        await t2
        await asyncio.sleep(0)  # let the done callbacks run
        return pm.erase_all(), pm.count()

    out = asyncio.run(go())
    assert out == ([("conn1", "val")], 1)
    return out


def test_pmon_task_completion():
    _both(_pmon_task, (JPMon, PPMon))


# -- misc pipeline ----------------------------------------------------------

def _pipeline_ok_chain(misc):
    OK = misc.OK
    out = misc.pipeline([
        lambda p, s: None,                       # keep
        lambda p, s: (OK, p + 1),                # new packet
        lambda p, s: (OK, p * 2, s + "b"),       # both
    ], 1, "a")
    assert out == (OK, 4, "ab")
    return out


def _pipeline_error_halts(misc):
    OK, ERROR = misc.OK, misc.ERROR
    calls = []
    out = misc.pipeline([
        lambda p, s: (OK, p + 1),
        lambda p, s: (ERROR, "denied"),
        lambda p, s: calls.append(1),
    ], 0, "s")
    assert out == (ERROR, "denied", "s") and calls == []
    return out


def _pipeline_error_with_state(misc):
    out = misc.pipeline([lambda p, s: (misc.ERROR, "bad", "new_state")],
                        0, "old")
    assert out == (misc.ERROR, "bad", "new_state")
    try:
        misc.pipeline([lambda p, s: ("bogus",)], 0, "s")
    except ValueError as e:
        return out, str(e)
    raise AssertionError("a bad stage return must raise")


def _run_fold(misc):
    out = misc.run_fold([lambda acc, s: acc + s, lambda acc, s: acc * 2],
                        1, 3)
    assert out == 8
    return out


def test_pipeline_ok_chain():
    _both(_pipeline_ok_chain, (jmisc, pmisc))


def test_pipeline_error_halts():
    _both(_pipeline_error_halts, (jmisc, pmisc))


def test_pipeline_error_with_state():
    _both(_pipeline_error_with_state, (jmisc, pmisc))


def test_run_fold():
    _both(_run_fold, (jmisc, pmisc))
