"""Scenario generation (dense and large-scale), PHY model, BLER evaluation,
mobility and the online controller."""

from sig_sdp_mmw_torch.env.env import EnvParams, WirelessEnv  # noqa: F401
from sig_sdp_mmw_torch.env.mob import Controller, MobileEnv  # noqa: F401
