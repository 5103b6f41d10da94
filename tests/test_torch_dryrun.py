"""The port's multi-device dry run (``parallel/dryrun.py``), the twin of
the reference's ``__graft_entry__.py::dryrun_multichip`` serving steps, on
``cpu`` repeated: at the default sizes over 8 and 2 devices and at the
north-star sizes (``model=8``, ``expert=8`` with 16 experts, ``seq=8``,
``pipe=8``). Each sharded step equals its unsharded run within the dry
run's f32 tolerance, the pools, the train step's loss and updated leaves
and the pipeline forward included."""

import pytest

from xllm_service_tpu_torch.parallel.dryrun import TOL, dryrun, main


@pytest.mark.parametrize("n,northstar", [(8, False), (2, False), (8, True)],
                         ids=["default8", "default2", "northstar"])
def test_dryrun_matches_unsharded(n, northstar):
    out = dryrun(["cpu"] * n, northstar=northstar)
    for part in ("decode", "decode_pool", "moe_decode", "moe_decode_pool",
                 "ring", "cp_decode", "train_loss", "train_params",
                 "pipeline"):
        assert 0 <= out[part] <= TOL, part
    assert out["train_mesh"] == out["decode_mesh"]
    if northstar:
        assert out["decode_mesh"]["model"] == 8
        assert out["moe_mesh"]["expert"] == 8
        assert out["seq_axis"] == 8
        assert out["pipe_stages"] == 8
    elif n == 8:
        assert (out["decode_mesh"]["data"], out["decode_mesh"]["model"]) == \
            (2, 4)
        assert (out["moe_mesh"]["expert"], out["moe_mesh"]["model"]) == \
            (4, 2)


def test_northstar_needs_eight_devices():
    with pytest.raises(ValueError, match="multiple of 8"):
        dryrun(["cpu"] * 4, northstar=True)


def test_command_line(capsys):
    assert main(["--device", "cpu", "--n", "2"]) == 0
    out = capsys.readouterr().out
    assert '"ring"' in out and '"train_loss"' in out and '"pipeline"' in out
