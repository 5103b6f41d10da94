"""Test fixtures of the port that also run as processes: the fake engine
(``testing/fake_engine.py``; ``python -m
xllm_service_tpu_torch.testing.fake_engine``)."""
