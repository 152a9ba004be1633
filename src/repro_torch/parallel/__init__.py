"""repro_torch.parallel — distributed pieces of the LM substrate.

Port of ``repro.parallel``: ``seqscan`` (the sequence-parallel linear
recurrences) and ``loss`` (the chunked cross-entropy, meshless).
Sharding rules, compression and the pipeline wait for ``ROADMAP.md``
queue 1 item 8e.
"""
