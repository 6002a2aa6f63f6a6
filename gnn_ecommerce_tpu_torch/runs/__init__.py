"""Ports of the JAX package's serving runs (``scripts/serve_*.py``) and of
its quality runs.

Each module mirrors one script under the script's own name and prints one
JSON line under the keys of the file that script wrote, plus the card's name
and power limit and a few keys of its own (each module's ``EXTRA_KEYS``).

The serving runs:

- ``serve_sustained_r3``: ``SERVE_r3.json``'s ``sustained_http_load``, 8
  clients x 64 users for 20 s against the service without the batcher, and
  a profile of one more window;
- ``serve_r4``: ``SERVE_r4.json``, 20 s windows alternating the batched and
  the unbatched server, big (8 x 64) and small (16 x 4) requests;
- ``serve_r5``: ``SERVE_r5.json``, interleaved 5 s slices: small requests
  batched against unbatched, big requests through the ``solo_min`` bypass
  against forced coalescing, int8 against f32, and the int8 top-20's
  overlap with the f32 one;
- ``serve_register_r5``: ``scripts/serve_register_r5.json``, a second
  checkpoint registered, flipped to, rolled back and unregistered through
  the HTTP management API, idle and under 8 x 64 clients (``under_load``).

``_load`` holds the load they share: client threads, windows, the
interleaved A/B protocol and the check that every answer is the plain
top-K of the version that was active. Each module's ``run`` takes a built
:class:`~gnn_ecommerce_tpu_torch.serve.RecommenderService` and its protocol
constants as arguments; its ``main`` loads a checkpoint:

    python -m gnn_ecommerce_tpu_torch.runs.serve_r5 -d DATA_DIR -c CKPT_DIR [--out x.json]

They run on ``cuda`` unless ``--device cpu`` is given, and raise on a failed
request or a wrong answer (non-zero exit, no JSON).

The quality runs, each with ``run(...)`` and ``--device`` and ``--out``,
and those that write checkpoints or files ``--work`` too (everything but
``--out`` is written under ``--work``, a temporary directory by default):

- ``full_corpus_r3``: the full-scale clustered corpus, its held-out edge
  lists and its saved artifact (``-o DIR``), which the runs below reuse
  with ``-d DIR``;
- ``svd_full_r5``: ``SVD_FULL_r5.json``, the SVD's surprise-parity and
  full-ranking metrics on the full corpus;
- ``bprmf_full_r5``: ``BPRMF_FULL_r5.json``, LightGCN at 0 layers;
- ``skyline_full_r3``: ``scripts/skyline_full_r3.json``, the weighted 2-hop
  co-occurrence skyline;
- ``movielens_bench``: ``MOVIELENS_r3.json`` (BASELINE config 2);
- ``config3_subsample_r3``: ``scripts/config3_subsample_r3.json`` (config 3);
- ``train_full_r5b``: ``TRAIN_FULL_r5b.json``, the main configuration's
  20 epochs, ``--seed`` setting the training's seed alone.

    python -m gnn_ecommerce_tpu_torch.runs.train_full_r5b -d DATA_DIR --seed 1 [--out x.json]

The last three scripts' runs, with the same command line:

- ``real_data_rehearsal``: ``scripts/real_data_rehearsal.json``, raw
  Kaggle-schema monthly CSVs (fabricated, or the real dump's with
  ``--raw-dir``) through ``cli.eda``, ``cli.preprocess``, ``cli.train``,
  ``cli.infer`` and one REST predict (``--rows``, ``--quick``, ``--work``);
- ``heavy_k_sweep_r3``: ``scripts/heavy_k_sweep_r3.json``, both sparse
  directions at root ``bench.py``'s shape by heavy-head size;
- ``depth_dim_sweep_r3``: ``scripts/depth_dim_sweep_r3.json``, the fast
  forward at layers {4, 5} x dim {80, 90} beside the layered one.

``bars`` holds each quality run's line to the TPU's numbers: a missed bar
raises (non-zero exit, no JSON).
"""
