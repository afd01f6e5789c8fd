"""The document-order kernel's design (an Euler tour of the element forest
ranked by a two-level ruling set, ``kernels/linearize.py``
``linearize_tour_model``) against the JAX package's ``device_linearize``,
exactly, on the CPU.

The inputs are the forests the ``forest`` kernel makes: of the fuzzed
documents of ``test_torch_kernels.py`` and more, of the seeded random
documents of
``test_torch_random_docs.py``, and of synthetic columns (one typed chain
as deep as the rows, a star of head inserts, many objects, odd parents,
P = 1 and P not a power of two). Each is ranked with the kernel's own
strides and with small ones, so that small inputs walk at both levels.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from automerge_tpu.api import AutoDoc
from automerge_tpu.ops import OpLog as JOpLog
from automerge_tpu.ops import merge as J
from automerge_tpu.storage.change import parse_change as j_parse_change
from automerge_tpu.types import ActorId, ObjType, ScalarValue
from automerge_tpu_torch.kernels import linearize as L

from .test_torch_kernels import CASE_IDS, CASES, _case
from .test_torch_random_docs import _history


def _reference(action, insert, elem_ref, obj_dense):
    """(the JAX package's elem_index, the forest's four arrays) as numpy."""
    c = {"action": jnp.asarray(action, jnp.int32), "insert": jnp.asarray(insert),
         "elem_ref": jnp.asarray(elem_ref, jnp.int32),
         "obj_dense": jnp.asarray(obj_dense, jnp.int32)}
    is_elem, parent_row, first_child, next_sib = J.forest(c)
    core = {"is_elem": is_elem, "parent_row": parent_row,
            "first_child": first_child, "next_sib": next_sib}
    ref = np.asarray(J.device_linearize(c, core))
    return ref, tuple(np.asarray(a) for a in (first_child, next_sib, is_elem))


# (level-1 stride, level-3 and level-4 targets): the kernel's, then small
# enough that a few dozen elements walk at every level and the block
# ranks a list of its own rulers
STRIDES = [(None, L.R3_TARGET, L.R4_TARGET), (2, 40, 6), (3, 1, 1)]


def _check(action, insert, elem_ref, obj_dense, strides=STRIDES):
    ref, (first_child, next_sib, is_elem) = _reference(action, insert, elem_ref,
                                                       obj_dense)
    infos = []
    for stride, r3, r4 in strides:
        got, info = L.linearize_tour_model(first_child, next_sib, is_elem,
                                           np.asarray(elem_ref), np.asarray(obj_dense),
                                           stride=stride, r3_target=r3, r4_target=r4)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"stride {stride}")
        assert got.dtype == L.torch.int32
        infos.append(info)
    return ref, infos


def _columns(P, elem_ref, obj_dense, insert=None):
    return (np.ones(P, np.int32), np.ones(P, bool) if insert is None else insert,
            np.asarray(elem_ref, np.int32), np.asarray(obj_dense, np.int32))


@pytest.mark.parametrize("P", [1, 2, 37, 1000, 4099])
def test_one_chain_as_deep_as_the_rows(P):
    """Sequential typing: each element inserted after the previous one."""
    elem_ref = np.arange(-1, P - 1)
    ref, infos = _check(*_columns(P, elem_ref, np.zeros(P)))
    np.testing.assert_array_equal(ref, np.arange(P))
    if P >= 1000:  # every level has rulers and walks past them
        assert all(r > 1 for r in infos[1]["rulers"])
        assert all(w > 1 for w in infos[1]["walks"])


@pytest.mark.parametrize("P", [1, 3, 1000, 4099])
def test_a_star_of_head_inserts(P):
    """Every element inserted at the head: P siblings of one root, in
    descending row order."""
    ref, _ = _check(*_columns(P, np.full(P, -1), np.zeros(P)))
    np.testing.assert_array_equal(ref, np.arange(P)[::-1])


def _random_forest(P, n_objs, seed, odd=False):
    """Elements inserted after a random earlier element of their object
    or at its head; with ``odd``, some rows no elements, some parents a
    non-element row and some elem_ref below -1 (the forest hangs those
    off its sentinel)."""
    rng = np.random.default_rng(seed)
    obj = rng.integers(0, n_objs, P)
    elem_ref = np.full(P, -1)
    last = {}
    for r in range(P):
        prev = last.setdefault(obj[r], [])
        if prev and rng.random() < 0.8:
            elem_ref[r] = prev[rng.integers(len(prev))]
        prev.append(r)
    insert = np.ones(P, bool)
    if odd:
        insert = rng.random(P) < 0.8
        elem_ref = np.where(rng.random(P) < 0.05, -1 - rng.integers(1, 4, P), elem_ref)
        elem_ref = np.where(rng.random(P) < 0.05,
                            rng.integers(0, np.arange(P) + 1) - 1, elem_ref)
    return _columns(P, elem_ref, obj, insert)


@pytest.mark.parametrize("P,n_objs", [(5, 1), (1000, 1), (3001, 7), (4099, 300)])
@pytest.mark.parametrize("odd", [False, True], ids=["forest", "odd"])
def test_random_forests_over_many_objects(P, n_objs, odd):
    _check(*_random_forest(P, n_objs, P + n_objs, odd))


def test_non_elements_and_padding_rows_are_minus_one():
    """PAD rows and map puts (insert False) between the elements."""
    P = 64
    action, insert, elem_ref, obj_dense = _columns(P, np.arange(-1, P - 1), np.zeros(P))
    insert[::3] = False
    action[-8:] = 15
    ref, _ = _check(action, insert, elem_ref, obj_dense)
    assert (ref[~insert] == -1).all() and (ref[-8:] == -1).all()


def _text_fuzz_log(n_forks, n_edits, seed):
    rng = random.Random(seed)
    base = AutoDoc(actor=ActorId(bytes([1]) * 16))
    t = base.put_object("_root", "t", ObjType.TEXT)
    lst = base.put_object("_root", "l", ObjType.LIST)
    base.splice_text(t, 0, 0, "the quick brown fox")
    base.insert(lst, 0, ScalarValue("int", 1))
    base.commit()
    forks = [base.fork(actor=ActorId(bytes([50 + i]) * 16)) for i in range(n_forks)]
    for f in forks:
        for _ in range(n_edits):
            ln = f.length(t)
            if rng.random() < 0.6 or ln == 0:
                f.splice_text(t, rng.randrange(ln + 1), 0, rng.choice("abcxyz"))
            elif rng.random() < 0.5:
                f.insert(lst, rng.randrange(f.length(lst) + 1), ScalarValue("int", 2))
            else:
                f.splice_text(t, rng.randrange(ln), 1, "")
        f.commit()
    return JOpLog.from_documents(forks)


def _check_log(log):
    cols = log.padded_columns()
    return _check(cols["action"], cols["insert"], cols["elem_ref"], cols["obj_dense"])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kernel_test_cases(case):
    """The fuzzed documents ``test_torch_kernels.py`` holds every kernel
    to: text splices, lists, same-position inserts, nested objects."""
    cols = _case(*case)[2]
    _check(cols["action"], cols["insert"], cols["elem_ref"], cols["obj_dense"])


@pytest.mark.parametrize("forks,edits,seed", [(4, 20, 0), (8, 40, 1), (16, 30, 2)])
def test_fuzzed_documents(forks, edits, seed):
    _check_log(_text_fuzz_log(forks, edits, seed))


@pytest.mark.parametrize("seed", range(8))
def test_seeded_random_documents(seed):
    base, rest = _history(seed)
    _check_log(JOpLog.from_changes([j_parse_change(b)[0] for b in base + rest]))


def test_scratch_and_strides_follow_p():
    """The level-1 stride grows as cbrt(P) past 4, its capacity holds the
    expected rulers with a margin, and the scratch words match
    ``lt_scratch_words``' layout."""
    assert L.ruler_stride(1) == 4 and L.ruler_stride(516_096) == 6
    assert L.ruler_stride((1 << 20) + 1) == 7
    assert L.ruler_threshold(8) == 1 << 29
    assert L.ruler_capacity(0, 8) == 1 and L.ruler_capacity(10, 8) == 20
    assert L.ruler_capacity(516_096, 6) == 2 * 516_096 // 6 + 1024
    P, r1 = 1000, 1178
    assert L.scratch_words(P, r1) == (12 * P + 16 * r1 + 1180 + 5 * L.R3_CAP + 4
                                      + 2 * 74 * 4)
    assert L.LAUNCHES == 8


def test_three_levels_and_the_block_walk_at_text_width():
    """A random forest as wide as the text fan-in: about one ruler in six
    at each level, R3_TARGET left for the block, every walk short."""
    cols = _random_forest(300_000, 3, 1)
    ref, infos = _check(*cols, strides=STRIDES[:1])
    rulers, walks = infos[0]["rulers"], infos[0]["walks"]
    assert abs(rulers[2] - L.R3_TARGET) < 400 and rulers[3] < L.R4_CAP
    assert max(walks) < 120
