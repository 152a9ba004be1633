"""repro_torch.parallel — distributed pieces of the LM substrate.

Port of ``repro.parallel``: ``sharding`` (the partition rules and the
port's block layout), ``seqscan`` (the sequence-parallel linear
recurrences and their halos) and ``loss`` (the chunked cross-entropy,
meshless or summed over a mesh).  Compression and the pipeline are
queued in ``ROADMAP.md`` (queue 1 item 8f).
"""
