"""The condensed arm of the sharded merge: its elementwise passes.

Replace the elementwise parts of ``automerge_tpu/parallel/sharding.py``
``_sharded_linearize_condensed`` (:255-335); the CUDA kernels are
``csrc/sharded.cu``, one thread per chain slot (``cond_init``,
``cond_succ``) or per row (``cond_expand``, called once per device
over all its shards' rows, into the replicated result). The doubling
loops between them are ``linearize.linearize_thread`` and
``linearize.linearize_rank`` over the R2 chain slots. Bound by bytes:
each input read once (the gathered tables at the slots this data
reaches), each output written once.
"""

from __future__ import annotations

import torch

from ..ops.oplog import PAD_ACTION
from . import _build
from ._args import expect, on_cuda, ptr, stream

_P, _I = _build.P_, _build.I_
_INIT_SIG = [_P] * 2 + [_I] + [_P] * 3 + [_P]
_SUCC_SIG = [_P] * 4 + [_I, _I] + [_P] * 2 + [_P]
_EXPAND_SIG = [_P] * 6 + [_I] + [_P] + [_I] * 3 + [_P] + [_P]


def cond_init_plain(centry, cpar):
    """Plain PyTorch version: the climb's start (ans, done, jump) per
    chain slot: done where the chain has a within-chain answer at its
    parent (``centry``) or its parent is an object root."""
    slots = torch.arange(cpar.shape[0], dtype=torch.int32, device=cpar.device)
    return centry.clone(), (centry != -1) | (cpar == -1), torch.where(
        cpar == -1, slots, cpar)


def cond_succ_plain(tail_ans, ans, chain_id, clen):
    """Plain PyTorch version: (cdist, cnxt) per chain slot: the chain's
    length, and the chain its last element's preorder successor heads
    (the sentinel slot R2-1 where none; the sentinel loops)."""
    R2 = tail_ans.shape[0]
    P = chain_id.shape[0]
    a = torch.where(tail_ans != -1, tail_ans, ans)
    cnxt = torch.where(a >= 0, chain_id[a.long().clamp(0, max(P - 1, 0))], R2 - 1)
    cnxt[R2 - 1] = R2 - 1
    return clen.clone(), cnxt.to(torch.int32)


def cond_expand_plain(chain_id, offset, obj_dense, insert, action, start_chain,
                      cdist, r0: int, count: int):
    """Plain PyTorch version: element rank of the rows [r0, r0+count) from
    the ranked chain distances: the object's first chain's distance minus
    the row's (its chain's, less its in-chain offset); -1 off the
    elements."""
    R2 = cdist.shape[0]
    sl = slice(r0, r0 + count)
    cid = chain_id[sl]
    start = start_chain[obj_dense[sl].long().clamp(0, start_chain.shape[0] - 1)]
    dist = cdist[cid.long().clamp(0, R2 - 1)] - offset[sl]
    dstart = cdist[start.long().clamp(0, R2 - 1)]
    is_elem = insert[sl] & (action[sl] != PAD_ACTION)
    return torch.where(is_elem & (cid >= 0) & (start >= 0), dstart - dist, -1)


def cond_init(centry, cpar):
    """(ans int32, done bool, jump int32), each [R2], from the chain
    tables ``centry``/``cpar`` (int32 [R2]). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    R2 = cpar.shape[0] if isinstance(cpar, torch.Tensor) else -1
    expect(centry, "centry", torch.int32, (R2,))
    expect(cpar, "cpar", torch.int32, (R2,))
    if not on_cuda(centry=centry, cpar=cpar):
        return cond_init_plain(centry, cpar)
    dev = cpar.device
    state = torch.empty(2, R2, dtype=torch.int32, device=dev)
    done = torch.empty(R2, dtype=torch.bool, device=dev)
    cond_init.launches += _build.launch(
        "amt_cond_init", _INIT_SIG, ptr(centry), ptr(cpar), R2, ptr(state[0]),
        ptr(done), ptr(state[1]), stream(cpar))
    return state[0], done, state[1]


cond_init.launches = 0


def cond_succ(tail_ans, ans, chain_id, clen):
    """(cdist, cnxt) int32 [R2] from the chain tables ``tail_ans``/``clen``,
    the resolved climb ``ans`` (int32 [R2]) and the rows' ``chain_id``
    (int32 [P]). CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    R2 = tail_ans.shape[0] if isinstance(tail_ans, torch.Tensor) else -1
    P = chain_id.shape[0] if isinstance(chain_id, torch.Tensor) else -1
    expect(tail_ans, "tail_ans", torch.int32, (R2,))
    expect(ans, "ans", torch.int32, (R2,))
    expect(chain_id, "chain_id", torch.int32, (P,))
    expect(clen, "clen", torch.int32, (R2,))
    if R2 < 1 or P < 1:
        raise ValueError(f"cond_succ needs R2 >= 1 and P >= 1, got {R2}, {P}")
    if not on_cuda(tail_ans=tail_ans, ans=ans, chain_id=chain_id, clen=clen):
        return cond_succ_plain(tail_ans, ans, chain_id, clen)
    state = torch.empty(2, R2, dtype=torch.int32, device=ans.device)
    cond_succ.launches += _build.launch(
        "amt_cond_succ", _SUCC_SIG, ptr(tail_ans), ptr(ans), ptr(chain_id),
        ptr(clen), R2, P, ptr(state[0]), ptr(state[1]), stream(ans))
    return state[0], state[1]


cond_succ.launches = 0


def cond_expand(chain_id, offset, obj_dense, insert, action, start_chain, cdist,
                r0: int, count: int, out=None):
    """elem_index int32 [count] of the rows [r0, r0+count) from the rows'
    int32 [P] chain_id/offset/obj_dense/action and bool [P] insert, the
    objects' first chains ``start_chain`` (int32 [n_objs2]) and the
    ranked chain distances ``cdist`` (int32 [R2]); written into ``out``
    (an int32 [count] view, e.g. a device's slice of the replicated
    result) when given, and returned. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    P = chain_id.shape[0] if isinstance(chain_id, torch.Tensor) else -1
    for name, t, dt in (
        ("chain_id", chain_id, torch.int32), ("offset", offset, torch.int32),
        ("obj_dense", obj_dense, torch.int32), ("insert", insert, torch.bool),
        ("action", action, torch.int32),
    ):
        expect(t, name, dt, (P,))
    n_objs2 = start_chain.shape[0] if isinstance(start_chain, torch.Tensor) else -1
    R2 = cdist.shape[0] if isinstance(cdist, torch.Tensor) else -1
    expect(start_chain, "start_chain", torch.int32, (n_objs2,))
    expect(cdist, "cdist", torch.int32, (R2,))
    if n_objs2 < 1 or R2 < 1:
        raise ValueError(f"cond_expand needs n_objs2 >= 1 and R2 >= 1, got "
                         f"{n_objs2}, {R2}")
    if not (0 <= r0 and 0 <= count and r0 + count <= P):
        raise ValueError(f"rows [{r0}, {r0 + count}) outside [0, {P})")
    named = dict(chain_id=chain_id, offset=offset, obj_dense=obj_dense,
                 insert=insert, action=action, start_chain=start_chain,
                 cdist=cdist)
    if out is not None:
        expect(out, "out", torch.int32, (count,))
        named["out"] = out
    if not on_cuda(**named):
        res = cond_expand_plain(chain_id, offset, obj_dense, insert, action,
                                start_chain, cdist, r0, count)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(count, dtype=torch.int32, device=cdist.device)
    cond_expand.launches += _build.launch(
        "amt_cond_expand", _EXPAND_SIG, ptr(chain_id), ptr(offset),
        ptr(obj_dense), ptr(insert), ptr(action), ptr(start_chain), n_objs2,
        ptr(cdist), R2, r0, count, ptr(out), stream(cdist))
    return out


cond_expand.launches = 0
