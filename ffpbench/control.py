"""The control: the reference put in the program's place, carrying the
delays in bfloat16, the nearest precision below the float32 the
configurations state.  A sound comparison has to find it not correct."""
from __future__ import annotations

import torch

from ffpbench.reference import Reference


class Control:
    def __init__(self, config: dict, traffic: dict, device,
                 dtype=torch.bfloat16):
        self.ref = Reference(config, traffic, device, dtype=dtype)
        self.labels = self.ref.labels

    def stream(self, key: int) -> dict:
        return self.ref.request(key)

    @staticmethod
    def readout(answer: dict):
        return answer["quantiles"], answer["counts"]

    @staticmethod
    def hist(answer: dict):
        return answer["hist"]

    def close(self) -> None:
        pass
