"""Command-line tools of the port, each run as ``python -m
duplexumiconsensusreads_torch.tools.<name>``: ``trace_report``,
``check_trace``, ``wirestat`` and ``devstat`` read a ``call --trace``
capture (the same flags, output and exit codes as the JAX package's
tools of those names); ``tune_ssc`` races the ssc reduction methods on
the card."""
