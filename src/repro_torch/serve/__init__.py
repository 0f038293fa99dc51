"""Serving layer: continuous-batching request engines over compiled
programs (the port's copy of repro.serve, single device).

    from repro_torch.serve.cnn_engine import CNNServeEngine   # CNN waves
    from repro_torch.serve.engine import ServeEngine          # LM decode
    from repro_torch.serve.base import ProgramServeBase, SlotScheduler
    from repro_torch.serve.kv_alloc import BlockAllocator     # paged KV
    from repro_torch.serve.program_cache import ProgramCache
"""
