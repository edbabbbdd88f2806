"""Streaming client API of the port.

Quickstart::

    from repro_torch.api import GenerationParams, TurboClient

    client = TurboClient.from_arch("internlm2-1.8b", smoke=False)  # cuda
    handle = client.submit([1, 2, 3, 4],
                           GenerationParams(max_new_tokens=16,
                                            temperature=0.8, seed=7))
    for token in handle.stream():
        print(token)
"""
from repro_torch.api.client import GenerationParams, RequestHandle, TurboClient

__all__ = ["GenerationParams", "RequestHandle", "TurboClient"]
