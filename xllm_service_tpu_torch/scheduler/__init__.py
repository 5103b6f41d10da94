"""L5/L4 scheduler core: orchestrator, managers, LB policies.

Parity: reference `xllm_service/scheduler/` (SURVEY.md §2.4-2.7).
"""
