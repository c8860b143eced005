"""The PyTorch port's model axes against the JAX package's one-device
step on the CPU (the counterpart of ``tests/test_torch_parallel_jax.py``
for tensor parallelism), the RNN heads' cases.

The cases of ``test_torch_parallel.build_case`` are built in both
packages from one numpy draw of their parameters; two gloo ranks take
the port's step, each holding the whole batch, the parameters the parts
declare split over the two model ranks: the RNN's embedding tables and
output projection (with the l2 term, whose sums over the split leaves
are summed over the ranks, the self-critical objective, whose sampled
steps gather their logits whole, and Adafactor, whose update runs on
the split leaves gathered whole) and the labeler's projection.
Loss and updated parameters agree with the JAX step within 1e-5.
``test_torch_model_axes_transformer_jax.py`` holds the Transformer's
cases.
"""

import pytest

from neuralmonkey_tpu_torch.ops import moe
from neuralmonkey_tpu_torch.parallel import pipeline, ring_attention, tensor

import test_torch_parallel as workers
import test_torch_parallel_jax as dp_jax

RUNS = [(f"{kind}_tp", kind, {"num_model_shards": 2})
        for kind in ("xent", "l2", "labeler", "self_critical",
                     "adafactor")]


# the calls counted in each case: the ring, the sequence split's
# reduce-scatter, the pipeline and the experts' split dispatch
COUNTED = {"ring": (ring_attention, "ring_attention"),
           "reduce_scatter": (tensor, "reduce_scatter"),
           "gpipe": (pipeline, "gpipe_apply"),
           "dispatch": (moe, "constrain_dispatch")}
NONE = {name: 0 for name in COUNTED}


def counted_losses(directory, cases):
    """``global_losses`` of ``cases``, and per case the calls of
    ``COUNTED``."""
    calls = dict(NONE)
    reals = {name: getattr(*where) for name, where in COUNTED.items()}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return reals[name](*args, **kwargs)
        return call
    for name, (module, attr) in COUNTED.items():
        setattr(module, attr, counting(name))
    counts = {}
    try:
        out = {}
        for case in cases:
            before = dict(calls)
            out.update(workers.global_losses(directory, [case]))
            counts[case[0]] = {k: calls[k] - before[k] for k in calls}
    finally:
        for name, (module, attr) in COUNTED.items():
            setattr(module, attr, reals[name])
    return {"losses": out, "counts": counts}


def run_counted(tmp_path_factory, runs):
    """The JAX references of ``runs``' cases, each rank's steps and its
    collectives' counts."""
    kinds = sorted({kind for _, kind, _ in runs})
    references = {kind: dp_jax._reference(kind) for kind in kinds}
    cases = [(name, kind, *references[kind][:3], kwargs)
             for name, kind, kwargs in runs]
    ranks = workers.run_ranks(str(tmp_path_factory.mktemp("axes")),
                              ["counted_losses"], (cases,),
                              module="test_torch_model_axes_jax")
    return (references, [r["counted_losses"]["losses"] for r in ranks],
            [r["counted_losses"]["counts"] for r in ranks])


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return run_counted(tmp_path_factory, RUNS)


@pytest.mark.parametrize("name,kind", [(name, kind)
                                       for name, kind, _ in RUNS])
def test_model_axes_take_the_jax_one_device_step(steps, name, kind):
    references, ranks, counts = steps
    dp_jax.check_step((references, ranks), name, kind)
    for rank in counts:  # none of the counted calls ran
        assert rank[name] == NONE
