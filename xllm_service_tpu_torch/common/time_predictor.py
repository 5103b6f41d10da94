"""Per-instance latency model for SLO-aware scheduling.

Parity: reference `common/time_predictor.{h,cpp}` — fitted at instance
registration from engine-profiled tables:

- TTFT: degree-2 polynomial in prompt length (reference fits a Vandermonde
  system with QR, `time_predictor.cpp:28-49`; numpy polyfit is the same
  least-squares problem).
- TPOT: linear in (batch_size, total_tokens) (`time_predictor.cpp:51-75`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class TimePredictor:
    def __init__(self) -> None:
        self._ttft_coef: np.ndarray | None = None    # [c0, c1, c2] for 1,x,x^2
        self._tpot_coef: np.ndarray | None = None    # [c0, c_batch, c_tokens]

    # ---- fitting -----------------------------------------------------------
    def fit_ttft(self, samples: Sequence[Sequence[float]]) -> bool:
        """samples: rows of [prompt_len, ttft_ms]; needs >= 3 points."""
        arr = np.asarray(samples, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[0] < 3 or arr.shape[1] != 2:
            return False
        x, y = arr[:, 0], arr[:, 1]
        A = np.stack([np.ones_like(x), x, x * x], axis=1)
        self._ttft_coef, *_ = np.linalg.lstsq(A, y, rcond=None)
        return True

    def fit_tpot(self, samples: Sequence[Sequence[float]]) -> bool:
        """samples: rows of [batch_size, total_tokens, tpot_ms]; >= 3 points."""
        arr = np.asarray(samples, dtype=np.float64)
        if arr.ndim != 2 or arr.shape[0] < 3 or arr.shape[1] != 3:
            return False
        A = np.stack([np.ones(arr.shape[0]), arr[:, 0], arr[:, 1]], axis=1)
        self._tpot_coef, *_ = np.linalg.lstsq(A, arr[:, 2], rcond=None)
        return True

    # ---- prediction (reference `time_predictor.cpp:77-93`) -----------------
    @property
    def has_ttft(self) -> bool:
        return self._ttft_coef is not None

    @property
    def has_tpot(self) -> bool:
        return self._tpot_coef is not None

    def predict_ttft(self, prompt_len: int) -> float:
        if self._ttft_coef is None:
            return 0.0
        c = self._ttft_coef
        return float(max(0.0, c[0] + c[1] * prompt_len + c[2] * prompt_len * prompt_len))

    def predict_tpot(self, batch_size: int, total_tokens: int) -> float:
        if self._tpot_coef is None:
            return 0.0
        c = self._tpot_coef
        return float(max(0.0, c[0] + c[1] * batch_size + c[2] * total_tokens))
