"""Prefill and decode on a mesh: the programs the dry run reckons
(``launch/cells.py``'s prefill and decode cells), run for real.

Gloo worlds of (2, 2) ranks (``tests/torch_mesh.py`` ``spawn``) build
the reduced dense (qwen3: heads sharded, KV heads not), ssm
(falcon-mamba: ``d_inner`` sharded) and MoE (llama4-scout: experts
sharded) configs sharded, and a (1, 4) world the MoE config with
``seq_shard``, and
each rank prefills its rows of the prompts and decodes greedy steps.
Each rank holds the logits of its rows and its block of every cache leaf
to one process running the whole model from the same seed, at the
serving tests' atol 1e-5, and the greedy tokens equal.  The MoE cases
run at capacity factor 100, where no token is dropped, since each rank
sizes its capacity from its own tokens.  Each rank's mesh reports its
collectives by kind, with their bytes (``Mesh.exchanges``)."""
import numpy as np
import pytest

import torch_mesh as tm

CASES = (("qwen3-32b", (2, 2), ()), ("falcon-mamba-7b", (2, 2), ()),
         ("llama4-scout-17b-a16e", (2, 2), (("capacity_factor", 100.0),)),
         ("llama4-scout-17b-a16e", (1, 4), (("capacity_factor", 100.0),
                                            ("seq_shard", True))))
ATOL = 1e-5


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    rng = np.random.default_rng(7)
    job = {"cases": CASES, "gen": 3,
           "tokens": rng.integers(0, 256, (4, 32))}
    return tm.spawn(4, "serve_steps", job, tmp, "serve")()


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}"
                         + ("-seq_sp" if len(c[2]) > 1 else ""))
def test_sharded_prefill_and_decode_equal_one_process(served, case):
    ranks = served[case]
    assert sorted(r[0] for r in ranks) == [0, 1, 2, 3]
    for rank, errs, cache_errs, same, kinds in ranks:
        assert len(errs) == 4
        assert max(errs) < ATOL, (rank, errs)
        assert max(cache_errs) < ATOL, (rank, cache_errs)
        assert same, rank
        # the real lines record their collectives by kind and bytes:
        # the row-parallel sums and the head's gather at least
        assert kinds["all_reduce"]["count"] > 0
        assert kinds["all_gather"]["count"] > 0
        assert all(k["bytes"] > 0 for k in kinds.values())
