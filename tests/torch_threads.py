"""One intra-op thread for the port's tests (``test_torch_*.py`` import
:func:`one_torch_thread`, an autouse fixture, for each module).

The port's CPU paths run many small ops (the weight draw alone runs
hundreds of f64 ops a tensor). Under the suite's parallel workers a pool
of one thread per core in every worker oversubscribes the host: a nano
MoE draw that takes 0.7 s on one thread took 27 s on eight beside three
other test processes. Rank and follower processes set their own
(``RANK_THREADS``, ``FOLLOWER_THREADS``).

``test_torch_rllib_offpolicy.py`` keeps the default pool: its DQN state
bound (1e-5, ``rllib_parity.STATE_RTOL``) holds at the default thread
count, and one thread sums the gradients in another order (a parameter
1.97e-5 from the reference's after the updates). That gap is f32
summation order, not a difference in the update: at f64 the two
packages agree to ~6e-14 on one thread
(``test_dqn_conv_gap_is_f32_summation_order``)."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
