"""ray_tpu_torch.rllib — the port of ``ray_tpu/rllib/``.

AlgorithmConfig → Algorithm with env runners (numpy inference on the
host: one local runner, or N on runner threads of the driver process
where the reference runs actors) and a LearnerGroup whose learners hold
their parameters and Adam state as tensors on a torch device (the card
unless ``.learners(device=...)`` says otherwise; one local learner, or N
on the ranks of a ``RankPool`` with their states averaged). Algorithms:
PPO (sync on-policy, single- and multi-agent via ``.multi_agent(...)``),
IMPALA (async + aggregators), APPO (async clipped surrogate), DQN
(prioritized replay + double-Q), SAC (continuous control), CQL, BC and
MARWIL (offline), DreamerV3 (model-based). Modules: MLP, Nature-CNN,
squashed-Gaussian, the RSSM. Connectors preprocess env→module
observations.

Not ported: ``Algorithm.as_trainable`` (Tune), which stays with the
reference's runtime.
"""
from .algorithm import Algorithm, AlgorithmConfig  # noqa: F401
from .appo import APPO, APPOConfig  # noqa: F401
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
from .dreamerv3 import DreamerV3, DreamerV3Config, DreamerV3Learner  # noqa: F401,E501
from .env_runner import (  # noqa: F401
    EnvRunnerGroup,
    SampleBatch,
    SingleAgentEnvRunner,
)
from .impala import IMPALA, IMPALAConfig  # noqa: F401
from .learner import LearnerGroup, PPOLearner, compute_gae  # noqa: F401
from .marwil import MARWIL, MARWILConfig  # noqa: F401
from .multi_agent import (  # noqa: F401
    MultiAgentEnv,
    MultiAgentEnvRunner,
    MultiAgentEnvRunnerGroup,
    MultiAgentPPO,
    MultiLearnerGroup,
    MultiRLModule,
    spec_from_spaces,
)
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
