"""The plain reference of ``configs/deepseek-v2-lite-16b-6l.json``: the
same model as ``deepseek-v2-lite-16b.py`` (its file holds the depth), so
this module is that one."""

from pathlib import Path

from perfbench.harness.bench import load_module

_whole = load_module(Path(__file__).with_name("deepseek-v2-lite-16b.py"))
globals().update({k: v for k, v in vars(_whole).items() if not k.startswith("__")})
