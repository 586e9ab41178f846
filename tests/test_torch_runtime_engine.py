"""The port's serving engine inside a port actor: a nano f32
``DecodeEngine(device="cpu")`` built in a runtime worker process from
weights that reach it as an object ref (``params_from_numpy`` of the
reference's ``init_params``, put once into the port's store), serving
requests whose streams must equal the reference engine's, run in the
test process on the same weights, at temperature 0 and at seeded 0.8.

This is the CPU counterpart of ``chip_smoke.runtime_phase``, where the
actor holds the card (``num_gpus=1``) and runs K1.
"""
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_tpu_torch import cloudpickle
from ray_tpu_torch.models import gpt as tgpt
from torch_runtime import case_time_limit, rt_port  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

# The worker processes cannot import this file (``tests/`` is not on their
# path): its functions and classes ship by value.
cloudpickle.register_pickle_by_value(sys.modules[__name__])

NANO = jgpt.CONFIGS["nano"]
J32 = dataclasses.replace(NANO, dtype=jnp.float32)
KW = dict(slots=3, chunk=4, max_len=64, prompt_buckets=(8, 16))
CASE_LIMIT_S = 120.0


def _drain(eng, prompts, max_news, seeds):
    """Every request at once, one consumer thread each; the streams in
    request order."""
    outs = {}

    def consume(i):
        outs[i] = np.concatenate(list(eng.stream(
            prompts[i], max_news[i], seed=seeds[i])))

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert not any(t.is_alive() for t in threads)
    return [outs[i] for i in range(len(prompts))]


class EngineHost:
    """Runs in a worker process: builds the port's engine on the CPU
    from the weights the runtime resolved from their ref."""

    def __init__(self, params):
        import torch as _torch

        from ray_tpu_torch.models import gpt as _tgpt

        self.params = params
        self.cfg = dataclasses.replace(_tgpt.CONFIGS["nano"],
                                       dtype=_torch.float32)
        self.dtypes = sorted({str(v.dtype) for v in params.values()})

    def serve(self, temperature, prompts, max_news, seeds):
        from ray_tpu_torch.serve.engine import DecodeEngine

        eng = DecodeEngine(self.params, self.cfg, temperature=temperature,
                           device="cpu", **KW)
        try:
            streams = _drain(eng, prompts, max_news, seeds)
            return [s.tolist() for s in streams], eng.stats()["dispatches"]
        finally:
            eng.shutdown()

    def info(self):
        import os

        return {"pid": os.getpid(), "dtypes": self.dtypes}


@pytest.fixture(scope="module")
def jax_params():
    return jgpt.init_params(jax.random.PRNGKey(0), NANO)


@pytest.fixture(scope="module")
def host(rt_port, jax_params):
    """The actor, and the ref its weights came through."""
    rt = rt_port
    params = tgpt.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_params), "cpu")
    ref = rt.put(params)
    actor = rt.remote(EngineHost).remote(ref)
    yield actor, ref, params
    rt.kill(actor)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_actor_engine_equals_reference(rt_port, jax_params, host,
                                       temperature):
    rt = rt_port
    actor, ref, params = host
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, NANO.vocab_size, (n,)).astype(np.int32)
               for n in (5, 11, 16, 7, 9)]
    max_news = [12, 9, 14, 10, 6]
    seeds = [3, 1, 4, 1, 5]
    streams, dispatches = rt.get(actor.serve.remote(
        temperature, prompts, max_news, seeds), timeout=100)
    want = JaxEngine(jax_params, J32, temperature=temperature, **KW)
    try:
        refs = _drain(want, prompts, max_news, seeds)
    finally:
        want.shutdown()
    for i, (got, exp) in enumerate(zip(streams, refs)):
        np.testing.assert_array_equal(np.asarray(got), exp,
                                      err_msg=f"stream {i}")
    assert dispatches > 0
    info = rt.get(actor.info.remote())
    assert info["dtypes"] == ["torch.float32"]
    import os

    assert info["pid"] != os.getpid()
    # the stored weights are what was put, bit for bit
    back = rt.get(ref)
    assert back.keys() == params.keys()
    assert all(torch.equal(back[k], params[k]) for k in params)
