"""Serving layer: continuous-batching request engines over compiled
programs (the CNN half of repro.serve).

    from repro_torch.serve.cnn_engine import CNNServeEngine   # CNN waves
    from repro_torch.serve.base import ProgramServeBase, SlotScheduler
    from repro_torch.serve.program_cache import ProgramCache
"""
