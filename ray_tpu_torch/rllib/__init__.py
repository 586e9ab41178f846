"""ray_tpu_torch.rllib — the port of ``ray_tpu/rllib/``'s numeric core.

AlgorithmConfig → Algorithm with a local env runner (numpy inference on
the host) and a LearnerGroup whose learners hold their parameters and
Adam state as tensors on a torch device (the card unless
``.learners(device=...)`` says otherwise; one local learner, or N on the
ranks of a ``RankPool`` with their states averaged). Algorithms: PPO,
DQN (prioritized replay + double-Q), SAC (continuous control), CQL, BC
and MARWIL (offline). Modules: MLP, Nature-CNN, squashed-Gaussian.
Connectors preprocess env→module observations.

Not ported yet: multi-agent (``multi_agent.py``), DreamerV3, IMPALA and
APPO; remote env-runner actors and ``as_trainable`` stay with the
reference's runtime.
"""
from .algorithm import Algorithm, AlgorithmConfig  # noqa: F401
from .bc import BC, BCConfig  # noqa: F401
from .connectors import (  # noqa: F401
    ConnectorPipeline,
    ConnectorV2,
    FlattenObs,
    FrameStack,
    NormalizeObs,
)
from .conv_module import ConvModule  # noqa: F401
from .cql import CQL, CQLConfig  # noqa: F401
from .dqn import DQN, DQNConfig, DQNLearner  # noqa: F401
from .env_runner import (  # noqa: F401
    EnvRunnerGroup,
    SampleBatch,
    SingleAgentEnvRunner,
)
from .learner import LearnerGroup, PPOLearner, compute_gae  # noqa: F401
from .marwil import MARWIL, MARWILConfig  # noqa: F401
from .offline_data import OfflineData, rollout_to_rows, to_columns  # noqa: F401,E501
from .ppo import PPO, PPOConfig  # noqa: F401
from .replay_buffer import (  # noqa: F401
    PrioritizedReplayBuffer,
    ReplayBuffer,
)
from .rl_module import (  # noqa: F401
    DiscreteMLPModule,
    RLModuleSpec,
    params_to_numpy,
    params_to_torch,
)
from .sac import SAC, SACConfig, SACLearner, SquashedGaussianModule  # noqa: F401,E501
