"""Configs (copies of the reference's): the DQN and ADFLL system configs
(:mod:`repro_torch.configs.adfll_dqn`) and the model zoo's
(:mod:`repro_torch.configs.base`, one module per ported architecture)."""
