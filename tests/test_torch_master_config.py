"""The port's ``ServiceOptions`` and its argv parser against the JAX
package's: the same argv gives the same options, flag by flag (a value
away from the default for every reference flag), all at once, and with
none; the port's master takes exactly the reference master's flags."""

import argparse
import dataclasses

import pytest
import torch

from xllm_service_tpu.common.config import ServiceOptions as RefOptions
from xllm_service_tpu_torch.common.config import ServiceOptions

torch.set_num_threads(1)   # six xdist workers share the CPU's cores

FIELDS = [f.name for f in dataclasses.fields(RefOptions)]


def _parse(cls, argv):
    p = argparse.ArgumentParser()
    cls.add_cli_args(p)
    return cls.from_cli_args(p.parse_args(argv))


def _argv_for(name: str) -> list[str]:
    """A value away from the default for one flag."""
    flag = "--" + name.replace("_", "-")
    cur = getattr(RefOptions(), name)
    if isinstance(cur, bool):
        return [flag]
    if isinstance(cur, int):
        return [flag, str(cur + 3)]
    if isinstance(cur, float):
        return [flag, repr(cur * 2 + 0.25)]
    return [flag, f"x-{name}"]


def test_field_sets_and_defaults_match():
    assert [f.name for f in dataclasses.fields(ServiceOptions)] == FIELDS
    assert dataclasses.asdict(ServiceOptions()) == \
        dataclasses.asdict(RefOptions())
    assert dataclasses.asdict(_parse(ServiceOptions, [])) == \
        dataclasses.asdict(_parse(RefOptions, []))


@pytest.mark.parametrize("name", FIELDS)
def test_each_flag_parses_as_the_reference(name):
    argv = _argv_for(name)
    got = dataclasses.asdict(_parse(ServiceOptions, argv))
    want = dataclasses.asdict(_parse(RefOptions, argv))
    assert got == want
    default = getattr(RefOptions(), name)
    if default is not True:   # a store_true flag cannot turn a True off
        assert got[name] != default


def test_every_flag_at_once():
    argv = [a for n in FIELDS for a in _argv_for(n)]
    assert dataclasses.asdict(_parse(ServiceOptions, argv)) == \
        dataclasses.asdict(_parse(RefOptions, argv))


def test_with_overrides_matches():
    kw = {"lease_ttl_s": 0.3, "load_balance_policy": "RR", "block_size": 8}
    assert dataclasses.asdict(ServiceOptions().with_overrides(**kw)) == \
        dataclasses.asdict(RefOptions().with_overrides(**kw))


def test_bad_values_fail_as_the_reference():
    for argv in (["--http-port", "x"], ["--lease-ttl-s", "fast"]):
        for cls in (ServiceOptions, RefOptions):
            with pytest.raises(ValueError):
                _parse(cls, argv)
