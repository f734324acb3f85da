#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``elephas_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line and then a ``wall`` line with its
seconds (set-up, checks and timed runs together); any failure exits
non-zero:

1. ``card``: the ``nvidia-smi`` name and power limit (also printed raw),
   then ``build``: every CUDA kernel compiled from ``elephas_tpu_torch/ops/
   csrc`` by ``nvcc`` (one process per source, all started together).
2. ``kernel``: each kernel's wrapper on the card against its plain PyTorch
   version on the same inputs, with the tolerance stated, then timed with
   CUDA events beside the plain version, one PyTorch library call that
   computes the same function (a yardstick the port never calls), and the
   least time the card could take (bytes over 3.35 TB/s or operations over
   67 TFLOP/s float32, whichever is larger; H100 SXM data-sheet peaks; for
   the flash-attention kernels the operations at 3xTF32, three TF32
   products of 494.7 TFLOP/s each, the 67 TFLOP/s figure beside it):
   LayerNorm forward and backward, each on both of its routes (one warp a
   row up to D 1024, one block a row past it; each case run twice for the
   same bits; the forward timed at the decode shape [8, 768] and the
   GPT-2 training shape [8192, 768], its route named), flash decode (K4:
   plain, GQA, window, ring, a window at positions past T, bf16; timed at
   the three position sets of phase 9's decode, each run twice for the
   same bits), flash attention forward,
   dq and dkv (eight cases: GPT-2 training shape, ragged T, GQA, window,
   non-causal, lse cotangent, bf16 at Dh 64 and 256), and their
   rope-on-load variants (six cases: the Llama-3-8B training shape, ragged
   T, GQA at Dh 64, window, bf16, per-row position offsets; timed beside
   two compositions of two PyTorch operations each, since no single call
   computes rope and attention). Every attention case runs dq and dkv
   twice (the same bits) and prints their errors and the plain version's
   against a float64 oracle.
3. ``serve``: GPT-2-small at full width (random weights from a seed)
   behind ``ServingEngine(n_slots=8)``: 16 greedy requests, prompts of
   32-256 tokens, 64 new tokens each. The kernel launch counters are set to
   0 just before and read just after; the run must have launched the
   flash-decode kernel once per layer per decode step and the LayerNorm
   kernel 2L+1 times per decode step and per prefill.
4. ``cross_check``: two of those requests, 8 new tokens, on a
   ``device="cpu"`` engine with the same weights (the plain path): the
   greedy tokens agree up to the first position whose CPU top-1/top-2
   logit gap is 1e-3 or less (a near tie, where either choice is right).
5. ``profile``: ten decode steps of a full batch under ``torch.profiler``:
   device time per step by kernel and the device's busy share.
6. ``train``: GPT-2-small at full width and depth, float32, trained by
   ``build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")``
   on one fixed batch of 8 rows of 1024 tokens: 2 warm-up and 5 timed
   steps with finite, falling losses, and per timed step exactly L
   launches of each flash-attention kernel (none of the rope-on-load ones:
   GPT-2's positions are learned) and 2L+1 of each LayerNorm kernel; then one step with ``vocab_block=8192`` against the dense head.
7. ``train_cross_check``: the loss and every parameter's gradient of one
   step at B=1, T=128 on the card against ``device="cpu"`` (the plain
   path), from the same weights.
8. ``generate``: greedy ``generate`` of 32 tokens after 4 prompts of 128:
   L flash-attention launches (the prefill) and L flash-decode launches
   per decode step; its tokens equal the ``ServingEngine``'s on the same
   prompts up to the first near tie (top-2 logit gap 1e-3 or less).
9. ``kernel`` ``paged_attention``: the paged-attention kernels (decode and
   chunk) against their plain versions over a page pool read through a
   block table (GPT-2 serving shape, GQA, a window, pages 8 and 64, a bf16
   pool, chunks of 256 rows at an empty and at an adopted prefix, chunks of
   4 at per-row positions, the Mixtral insert; each chunk run twice for
   the same bits); the decode timed at three position sets (the checks'
   positions 15-1023, the serve mix's 32-320 and a full cache, each run
   twice for the same bits), the chunk at GPT-2's and Mixtral's 256-row
   inserts, each beside the plain version, SDPA over the equivalent dense
   cache with an explicit mask, and the bound (the chunk's operations at
   3xTF32 on the tensor cores, as flash attention's).
10. ``serve_paged``: the ``serve`` mix through ``ServingEngine(paged=True,
    page_size=16)``: L paged-decode launches per decode step, L paged-chunk
    launches per prefill insert, no dense flash-decode launch, 2L+1
    LayerNorm launches per step and insert; greedy tokens equal the dense
    engine's up to the first near tie; ``kv.check()`` passes. Then
    ``profile_paged``: ten paged decode steps under ``torch.profiler``.
11. ``prefix``: 16 requests sharing a 192-token prefix (distinct 16-64-token
    suffixes, 32 new tokens), with and without the prefix cache: the pages
    adopted equal the CPU paged engine's count on the same mix, and the
    tokens agree up to near ties.
12. ``preempt``: 8 requests of 256 + 64 tokens in a pool that cannot hold
    them all: preemptions happen, the tokens equal an unpressured paged
    run's up to near ties, and every page comes back.
13. ``paged_cross_check``: two requests, 8 new tokens, on a ``device="cpu"``
    paged engine against the card's paged tokens.
13a. ``kernel`` ``spec_verify_shapes``: K5-chunk at the paged speculative
    verify's shape (GPT-2's 8 slots, C 2 and 4 rows at unaligned per-slot
    positions of the serve mix, some crossing a page edge) and K3-fwd at
    the verify chunk's ``[8·C, 768]`` rows, against their plain versions,
    twice for the same bits, timed beside the plain version, SDPA over the
    dense view (``F.layer_norm`` for K3) and the bound.
13b. ``serve_spec``: the ``serve`` mix through ``ServingEngine(speculate_k=4)``
    with the n-gram drafter, a self-draft ``ModelDrafter`` and a drafter at
    DistilGPT2's widths (6 layers of GPT-2-small's, random weights from
    another seed): exact launch counts (K3-fwd 2L+1 per verify round,
    sequential step and insert and 2L_d+1 per draft step and draft insert;
    K4 L per sequential step and L_d per draft step; no K5), tokens equal
    to ``serve``'s up to near ties; verify rounds, acceptance, tokens per
    row per round, tok/s, ms a round and its host share beside ``serve``'s.
13c. ``serve_spec_sampled``: eight of the mix's prompts at temperature 0.8,
    the speculative stream against a ``speculate_k=1`` engine's up to each
    request's first position whose noisy margin (scaled logits plus the
    engine's Gumbel noise) is 1e-3 or less.
13d. ``serve_spec_paged``: the mix on ``paged=True, page_size=16`` at
    ``speculate_k=4``, the n-gram drafter and a self-draft: K5-chunk L per
    insert and per verify round, K5-decode L per sequential step, K4 only
    the drafter's; tokens equal to ``serve_paged``'s up to near ties;
    ``kv.check()`` passes.
13e. ``generate_spec``: ``generate_speculative`` at B 4, greedy,
    ``spec_k=4``, on the ``generate`` phase's prompts, with the
    DistilGPT2-width drafter and a self-draft, the device loop and the host
    loop: tokens equal to ``generate``'s up to near ties; K2-fwd L + L_d
    (the two prefills), K4 L_d (spec_k + 1) a round, K3-fwd 2L+1 per
    target prefill and verify round and 2L_d+1 per draft prefill and step.
13f. ``spec_cross_check``: two layers at GPT-2's widths, the speculative
    engine (dense and paged) on the card against the same engine on
    ``device="cpu"``.
14. ``kernel`` ``grouped_matmul``: K6-gmm (``gmm``, ``gmm_t``) and K6-tgmm
    against their plain versions at the MoE serving decode layout (8 routed
    rows in 1152), the training layout (9216 rows, the w1 and w2 shapes), a
    hungry expert, ragged K/N and bf16 inputs; timed beside the plain
    version, a per-expert ``torch.matmul`` (``tgmm``: per-tile ``bmm``)
    yardstick, ``torch._grouped_mm`` in bf16 where it exists (for ``tgmm``
    over the contraction: ``mat_a = lhs.T``, ``offs`` the experts' row
    ends, beside ``tgmm`` on the same bf16 rows), and the bound (all three
    on the tensor cores: float32 operations at 3xTF32, the 67 TFLOP/s SIMT
    figure beside it); ``tgmm`` twice for the same bits, an expert without
    rows exactly zero. The kernel line has ``gmm`` twice: at the decode
    layout and, as ``gmm_train``, at the training layout.
15. ``serve_moe``: Mixtral-8x7B's widths at 4 of 32 layers (float32, random
    weights drawn on the card, cache 2048), ``moe_dispatch="gmm"``, behind
    ``ServingEngine(n_slots=8)``: 16 greedy requests, prompts of 32-256
    tokens, 32 new each; exactly 3L ``gmm`` launches per decode step and per
    insert, L flash-decode per step, no backward kernel; a profiled decode
    window. Then ``serve_moe_paged``: the same mix on ``paged=True``, L
    paged-decode per step, tokens equal to the dense run's up to near ties.
16. ``moe_cross_check``: one layer at full width, two requests, 8 new tokens,
    card against a ``device="cpu"`` engine.
17. ``train_moe``: 2 layers, float32, ``adam_compact(1e-3)``, ``attn="flash"``,
    B 4 x T 1024: 2 warm-up and 3 timed steps, falling finite losses, per
    step exactly 5L ``gmm``, 3L ``gmm_t``, 3L ``tgmm`` and L of each
    rope-on-load flash-attention kernel (none of the plain ones); a
    profiled step.
18. ``train_moe_cross_check``: one layer, B 1, T 64: loss and gradients on
    the card against the CPU.
19. ``kernel`` ``fused_xent``: K1-fwd and K1-bwd against their plain
    versions at the MLP fit's shape [1024, 10], ragged [1000, 10], the host
    path's [128, 10], [51, 10] and [77, 10], wide [4096, 50257] and bf16
    logits, and each side of every route boundary (C 128 / 129, 1024 /
    1025, the cluster's capacity and one past it), each
    with a zero-label and a soft-label row, each run twice for the same
    bits; timed beside the plain versions, ``F.cross_entropy`` with
    probability targets (its autograd backward for K1-bwd), the bound and
    its share, and the launch floor (an empty kernel at the fit shape's
    grid).
20. ``fit_mlp``: the reference's MNIST MLP (the committed Keras JSON with a
    logits head, ``elephas_tpu_torch/configs/mnist_mlp_logits.json``) on
    65536 MNIST-shaped samples through ``SparkModel.fit``: 8 workers,
    synchronous, batch 128, 4 epochs, ``validation_split=0.1``; exactly
    E*S K1-bwd and E*(S + Sv) K1-fwd launches, falling loss, rising
    accuracy; samples/s raw and marginal (4-epoch minus 1-epoch fits); a
    profiled 1-epoch fit; ``evaluate`` and ``predict`` on 2048 held-out
    samples.
21. ``fit_matrix``: the five compiled-path schedules on the card (8192
    samples, 2 epochs): falling losses, K1 launched once per step.
22. ``fit_cross_check``: a short fit with dropout off, card against
    ``device="cpu"`` from the same weights and order: histories and
    weights within 1e-4.
23. ``fit_host``: the reference's defaults on the same JSON at full width,
    ``SparkModel(json)`` with no mode arguments (asynchronous, an HTTP
    parameter server, ``frequency="epoch"``, dropout on): 2 workers (one
    thread each, both launching K1), 32768 samples, batch 128, 4 epochs,
    ``validation_split=0.1``; exactly sum over workers of E (S_w + Sv_w)
    K1-fwd and E S_w K1-bwd launches and no other kernel, falling losses,
    held-out accuracy over 0.5, the server's pushes and pulls those of the
    schedule; samples/s, the median pull and push round trip and the
    push's pickling; the same fit at 1 and 2 workers, a worker's ms a step
    (do the threads overlap?).
24. ``fit_host_matrix``: six host cells (8192 samples, 2 workers, 2 epochs):
    asynchronous http batch, asynchronous socket epoch, hogwild socket
    batch, hogwild native epoch (``native/ps_server.cpp`` built here by
    ``make``), synchronous ``comm="host"``, asynchronous http epoch with
    int8 compression; exact K1 counts, falling losses; a K1 error injected
    in a worker fails the fit after the task retries.
25. ``fit_host_cross_check``: one worker, dropout off, http/epoch and
    socket/batch on the card against ``device="cpu"`` from the same weights
    and seeded orders: histories and weights within 1e-4.
26. ``checkpoint``: a synchronous 4-epoch fit against a 2-epoch
    checkpointed fit resumed by a new ``SparkModel`` to 4, dropout on,
    within rtol 1e-5 / atol 1e-6; ``save`` → ``load_spark_model`` →
    ``predict`` the same bits.
27. ``train_llama``: Meta-Llama-3-8B's widths at 4 of 32 layers (float32,
    random weights drawn on the card), ``build_lm_train_step(model, None,
    adam_compact(1e-3), attn="flash")`` on one fixed batch of 4 x 2048
    tokens: 2 warm-up and 3 timed steps, falling finite losses, per step
    exactly L launches of each rope-on-load flash-attention kernel and
    none of the plain ones; a profiled step; then ``train_llama_bf16``: 2
    steps from the same initial weights with ``compute_dtype="bfloat16"``,
    the first loss within 1e-2 of the float32 run's, the second lower.
28. ``train_llama_cross_check``: one layer, B 1, T 64: loss and gradients on
    the card against the CPU.
    Then LoRA and multi-tenant serving at the same widths, each phase
    followed by a ``wall`` line:
    ``serve_multi_tenant``: ``MultiTenantLM`` (4 of 32 layers, 8 adapters
    of rank 16 on q, k, v and o; base weights drawn on the card, adapters
    1-7 given random ``B``) behind ``ServingEngine(paged=True,
    page_size=16, n_slots=8, max_len=512)``: the ``serve`` mix's 16 prompt
    lengths over Llama-3's vocabulary, 32 greedy new tokens, request ``i``
    on adapter ``i % 8``: exactly L K5-decode a decode step, L K5-chunk an
    insert, no K4; adapter 0's requests equal the base model on the same
    engine token for token; each tenant equals a dense engine on its
    ``merged_params`` up to near ties; some tenant differs from the base;
    ``kv.check()``; ms a step and tok/s beside the base model's, the two in
    turns, and a profiled decode window of each.
    ``multi_tenant_prefix``: one 192-token prefix, 8 suffixes of 16-64,
    adapters 1 and 2 in turn: pages adopted within an adapter, none across,
    the count equal to a ``device="cpu"`` engine's; cache on against off.
    ``serve_multi_tenant_spec``: the first mix at ``speculate_k=4`` with
    ``ModelDrafter(mt, params)`` (a per-adapter self-draft): acceptance
    100%, exact K4 / K5-chunk / K5-decode counts, tokens equal to
    ``serve_multi_tenant``'s up to near ties.
    ``train_lora``: ``apply_lora(keys=("wq", "wv"), rank=16)`` on
    ``train_llama``'s initial weights, ``build_lora_lm_train_step(...,
    adam(1e-3), attn="flash")`` on its 4 x 2048 batch: its first loss,
    2 warm-up and 3 timed steps falling, L of each rope K2 a step, every
    frozen tensor bit-identical, every ``b`` moved, optimizer state at most
    2 x trainable + 16; ``merge_lora`` and ``save_lora`` / ``load_lora``
    against the adapted logits.
    ``lora_cross_check``: one layer of the trained adapters, B 1, T 128:
    loss and every factor gradient on the card against the CPU.
28a. ``kernel`` ``window_shapes``: the windowed branches at Mistral-7B's
    heads (H 32, Hkv 8, Dh 128), window 4096: the rope-on-load K2-fwd, dq
    and dkv at B 1 x T 8192; K4 with ``ring=True`` over
    ``aligned_cache_length(4096 + 1)`` = 4352 slots at positions 4000-4700
    (before, at and past the wrap); K5-decode at 4 slots past 4096 and
    K5-chunk at the paged insert's 4864-row bucket; each against its
    plain version at its existing tolerance, twice for the same bits, and
    timed beside the plain version, SDPA with an explicit window (or
    ring-age) mask and the bound over the visible pairs or rows.
28b. ``generate_window``: Mistral-7B-v0.1's widths at 4 of 32 layers
    (random weights drawn on the card), window 4096 on every layer:
    greedy ``generate`` of 64 tokens after prompts of 4608 at B 2 over a
    rolling cache of 4352 slots (the prompt takes ``write_prompt_cache``'s
    scatter branch): exactly L K2-fwd (window 4096) for the prefill and L
    K4 (``ring=True``) a decode step; tokens equal to the argmax of the
    card's own ``apply(attn="dense")`` up to near ties; the same weights
    without a window give other logits past position 4096; then a
    windowed ``generate_speculative`` self-draft at ``spec_k=4`` (B 1, 32
    new) on the margined ring, equal to the greedy tokens up to near ties.
28c. ``train_window``: the same model, ``attn="flash"``, ``vocab_block=8192``,
    ``adam_compact(1e-3)``, B 1 x T 8192: 1 warm-up and 2 timed steps,
    exactly L rope-on-load K2-fwd, dq and dkv a step, each with window
    4096; then one layer at B 1, T 4608 against ``attn="dense"`` on the
    card (loss rtol 1e-4, each gradient within 1e-3 of its scale).
28d. ``serve_window`` / ``serve_window_paged``: the same widths with the
    per-layer windows ``(4096, None, 4096, None)``, 4 greedy requests of
    4200-4600 prompt tokens and 32 new through 4 slots (``max_len`` 4864;
    paged at page 16): exactly L K4 (or K5-decode) a decode step and L
    K5-chunk an insert, each layer with its own window; ``kv.check()``;
    paged tokens equal to dense up to near ties.
28e. ``beam``: ``generate_beam`` at GPT-2-small width, B 2, prompts of 64,
    32 new: ``beam_size=1`` equal to greedy ``generate`` bit for bit;
    ``beam_size=4`` with exactly L K2-fwd and L K4 launches a step over the
    8 rows.
28f. ``train_phases``: ``build_lm_train_phases`` on ``train``'s GPT-2 step:
    the forward, backward (grad minus forward), optimizer and step times;
    the phases' losses equal the step's, ``apply`` of the grad phase's
    gradients is the step's update bit for bit.
28g. ``train_options``: the step's options at a reduced depth, each against
    the identity its CPU test pins: Llama-3-8B widths at 1 layer,
    ``remat`` "dots" and "full", ``accum_steps=2``, ``fused_apply``;
    Mixtral-8x7B widths at 1 layer, ``ep_groups=2`` (the K6 executor
    against the slot executor) and bf16 expert storage.
    After each of 28a-28g a ``wall`` line gives its seconds.
29. ``fit_cnn``: ``examples/mnist_cnn_async.py``'s three fits of its CNN
    (Reshape, Conv2D, MaxPooling2D; the committed JSON with a logits head,
    ``elephas_tpu_torch/configs/mnist_cnn_logits.json``) at full width on
    16384 samples, batch 64, epoch merges (``merge="mean"``), 2 epochs:
    asynchronous and hogwild on the compiled path (8 workers), asynchronous
    over HTTP on the host path (2 worker threads); exact K1 counts, falling
    losses, held-out accuracy over 0.5, samples/s and ms a step.
30. ``fit_bn``: the same CNN with a BatchNormalization after each Conv2D
    (``mnist_cnn_bn.json``), 8 workers, synchronous at epoch and batch
    frequency and asynchronous at epoch frequency: exact K1 counts, falling
    losses, moving statistics moved and finite; the installed weights and
    statistics are the mean merge of the replica stacks.
31. ``fit_lstm``: ``examples/ml_pipeline_imdb_lstm.py``'s Embedding(2000,
    32) -> LSTM(32) -> Dense(1, sigmoid) (``imdb_lstm.json``) on 8192
    sequences of 80 ids, batch 32, 8 workers, synchronous, 2 epochs:
    falling loss, no kernel of the port launched (a sigmoid head), ms a
    step and the device's busy share of a profiled epoch over 1024 of the
    sequences.
32. ``fit_layers_cross_check``: each of the three models fitted on the card
    and on ``device="cpu"`` from the same weights and order: histories and
    weights (moving statistics included) within 1e-4; the
    BatchNormalization CNN's train and grad steps (loss sums, gradients,
    moved statistics) within 1e-4 of scale; then that CNN's
    gradient-synchronous fit on the card and on the CPU from the same
    weights and order, both predicting 1024 held-out rows: the largest
    softmax-probability difference and the argmax agreement on rows whose
    top-2 logit margin exceeds 1e-3.
32a. ``fit_resnet``: ``examples/resnet50_spark.py``'s ResNet-50 (the
    committed Functional JSON, 32x32 inputs, 10 logits) through
    ``SparkModel(json, mode="synchronous", remat=...)``: 1024 images at 1
    worker and 2048 at 4, batch 16, 2 epochs, each without and with ``remat``:
    exact K1 counts (E S each way; E 2S K1-fwd under remat), falling
    losses, ms a step, samples/s and peak device memory of each; a
    profiled epoch of 1 worker with remat; K1 timed at [16 W, 10].
32b. ``fit_resnet_cross_check``: two steps, each from the same weights on
    every side: remat against plain on the card, every array within 1e-4
    of its scale; the card against the CPU, the loss, the moved statistics
    and the head within 1e-4, every array within 4 times the CPU's own
    distance to the float64 step.
32c. ``fit_recurrent``: the IMDB model with a masked GRU (4096 padded
    sequences, 4 workers, 2 epochs), no kernel launched, then card against
    CPU; then the IMDB LSTM with ``dropout`` and ``recurrent_dropout`` 0.2:
    a falling loss, and its inference equal to the dropout-free forward
    from the same weights.
32d. ``fit_options``: an MNIST-shaped CNN with conv ``groups``,
    channels_first, BatchNormalization on axis 1, a frozen one and
    ``Dropout(noise_shape)``: exact K1 counts, the frozen arrays unchanged,
    then card against CPU.
32e. ``kernel`` ``fused_xent_fp16``: K1-fwd and K1-bwd on float16 logits
    against their plain versions (dx within one fp16 ulp of each element)
    at the mixed fits' shapes and [4096, 50257], timed beside the plain versions and ``F.cross_entropy`` in
    float16, with the bound in bytes.
32f. ``fit_mixed``: ResNet-50 under ``mixed_bfloat16`` (batch 16, 1 epoch
    on 1024 images at 1 worker and at 4) and the MNIST MLP under
    ``mixed_float16`` (4 workers): exact K1 counts, each launch on bf16
    (fp16) logits, no other kernel; ms a step and peak memory beside
    ``fit_resnet``'s float32 figures; a profiled epoch of each ResNet-50
    config at 1 worker.
32g. ``fit_mixed_cross_check``: one mixed_bfloat16 ResNet-50 step and a
    mixed_float16 MLP fit, card against CPU by their updates: the loss at
    the bf16 pin 2e-2, the moved statistics against the CPU's
    bf16-to-float32 distance, the trained arrays' norms, the MLP's
    updates within 2e-2 of their scale.
32h. ``fit_losses_metrics``: compiled MLP fits with ``KLDivergence()``
    and ``"poisson"``, Keras ``evaluate`` with three metrics, and a host
    fit with ``class_weight``, a patience callback and ``validation_freq``,
    each against the CPU.
32i. ``fit_transfer``: Keras's transfer-learning recipe on the ResNet-50
    base (the committed ``resnet50_transfer_logits.json`` and
    ``resnet50_finetune_logits.json``), each stage at 1 worker, batch 16, 2
    epochs on 1024 images: exactly E S K1 launches each way; the frozen
    stage keeps the base bit for bit and calls no convolution backward,
    the fine-tuning stage moves the base and its statistics; ms a step,
    device ms, launches a step and peak memory beside ``fit_resnet``'s.
32j. ``fit_transfer_cross_check``: the frozen stage's fit and a
    fine-tuning step, card against CPU.
32k. ``fit_graph_options``: the small models of
    ``configs/graph_options.json`` (``return_state`` / ``initial_state``
    LSTMs, a masked classifier, a ``stateful`` LSTM on both paths, a
    ``ctc`` tagger, an MLP with AUC, Precision and F1Score in a host fit's
    history and in ``evaluate``), card against CPU.
33. ``ml_mlp``: ``examples/ml_mlp.py`` through the port without Keras: a
    DataFrame of 8192 MNIST-shaped rows, ``ElephasEstimator`` over the
    committed logits-head JSON (8 workers, synchronous, batch 64, 3 epochs,
    ``validation_split=0.1``), ``fit`` and ``transform`` of 1024 held-out
    rows: exactly E (S + Sv) K1-fwd and E S K1-bwd launches, the training
    loss fell, the ``prediction`` column is the argmax of the trained
    network's predictions exactly; ms a step.
34. ``ml_pipeline_lstm``: ``examples/ml_pipeline_imdb_lstm.py``'s
    ``Pipeline(stages=[ElephasEstimator])`` over the LSTM JSON on 8192 id
    sequences (batch 64, 2 epochs, 8 workers): no kernel launched, the
    trained weights bit for bit those of ``SparkModel.fit`` on the same
    rows, a falling loss; the test frame's accuracy and ms a step.
35. ``ml_persist``: ``ml_mlp``'s estimator and transformer saved and
    loaded back (``load_ml_estimator``, ``load_ml_transformer``): the same
    params, the same predictions bit for bit on the card; both load on the
    CPU too.
36. ``hyperparam``: ``examples/hyperparam_optimization.py``'s search,
    ``HyperParamModel(sc, num_workers=4).minimize`` (3 evaluations each, the
    first Dense's units and the first Dropout's rate searched, each trial a
    ``SparkModel`` fit of the MNIST MLP on 2048 rows), then
    ``best_models(2)``: 12 trials within their spaces, each recording its
    card, scored by held-out cross-entropy, not all equal; exact K1 counts
    over every trial, counted from the 4 worker threads; the rebuilt best
    model is the trial of least loss and predicts exactly as its network;
    the ensemble's members are the second search's two least-loss trials
    and its prediction is [n, 10].

37. ``fleet``: GPT-2-small at full width and depth (``serve``'s weights)
    behind ``FleetRouter`` with two dense partitions of 8 slots sharing the
    params (each its own cache), on a ``SimClock`` (0.05 s a fleet step):
    the reference chaos scenario's ``TrafficModel`` trace (seed 3, 4 rps,
    12 s, 4 tenants, half sampled, burst 2) at GPT-2's vocabulary, prompts
    of median 64 and at most 256 tokens, outputs of median 32 and at most
    64; partition 0 killed at 2.0 s, a replacement joining at 2.5 s: every
    request terminal, migrations, exactly L K4 a decode step and 2L+1
    K3-fwd a step and an insert over every engine built (the killed one
    included), the deadline-miss share; then the same replay on the card's
    own time (``time.monotonic``): fleet tok/s, TTFT and ITL p50 / p99.
38. ``fleet_paged``: the same on paged partitions (page 16), ``kv.check()``
    after every fleet step, exactly L K5-decode a decode step and L
    K5-chunk an insert.
39. ``fleet_cross_check``: each request's stream in the chaos runs (dense
    and paged, migrated or not) against the undisturbed run's up to its
    first near tie (top-2 gap 1e-3 or less; for a sampled row the gap of
    the scaled logits plus the engine's Gumbel noise): how many requests
    and positions were compared.
40. ``stream``: ``SparkModel.fit_stream`` over a socket parameter server,
    ``train_fn`` the port's LM train step (``attn="flash"``, B 4 x T 512)
    at GPT-2-small's width, 4 of its 12 layers, publishing every commit
    through ``engine_sink`` into a live paged engine that keeps decoding
    three long requests between commits: 5 micro-batches, one a poisoned
    update the eval gate rolls back (publish history publish, publish,
    rollback, publish, publish), the engine's weights version following
    each publish, a probe after each swap equal to a fresh engine on the
    published weights up to near ties, exactly L K2-fwd, dq, dkv and 2L+1
    K3-bwd a train step from ``train_fn``; then ``stream_fleet``: the same
    through ``router_sink`` into a two-partition fleet (2 commits).
41. ``resilience_fit``: the MLP fit (8192 samples, batch 128, 2 epochs) on
    the card: the host path over a socket server under a ``FaultPlan``
    (dropped pushes, partition 1 crashed at its second push, partition 0 a
    straggler) and a ``RetryPolicy``: the server's version is the pushes
    less the dropped ones (each applied once), exact K1 counts from the
    worker threads (the crashed attempt's epochs included); a hot standby
    with the primary killed mid-fit: failover, no committed update lost;
    the compiled path with a ``HeartbeatRegistry`` quorum of 3 of 4 and
    worker 3 expired: its mask, exact K1 counts, weights other than the
    all-worker fit's, and quorum lost when a second worker expires.
42. ``soak``: ``run_soak`` over five seeded schedules on the card, one of
    each stack (synchronous fit with a killed worker, asynchronous and
    hogwild fits under the wire and logical storm, ``fit_stream``, the
    paged fleet replay): every schedule completes or dies typed.
    After each of 37-42 a ``wall`` line gives its seconds.
43. ``fleet_autoscaler``: ``fleet``'s traffic model over 6 s through a GPT-2-small fleet
    that starts at one partition of 2 slots under an ``Autoscaler`` (1-4
    partitions) on a ``SimClock``: a scale-up under the load, every request
    terminal, exact K4 and K3-fwd counts over every engine built.
44. ``stream_supervised``: ``fit_stream`` with ``checkpoint_dir`` (under
    ``TrainingSupervisor``), ``train_fn`` crashing once: three commits for
    three batches, the checkpoint's cursor and weights, exact K2 and K3-bwd
    counts of the train steps.
45. ``round_options_fit``: the MLP fit's synchronous host path with
    ``round_deadline_s`` (quorum 3 of 4, one partition abandoned) and with
    ``backup_stragglers=False`` (a straggler waited for): exact K1 counts.
46. ``fit_elastic``: ``SparkModel(elastic=ElasticConfig(...))`` over the
    committed MLP JSON, 16384 samples, 6 rounds, 2→3→4→3 host processes
    (a scale-up, a late join, a SIGKILL mid-round): the reference's pinned
    trace, meshes, versions, contributors and counters; every committed
    contribution on ``cuda`` with exactly its shard's K1-fwd and K1-bwd
    launches, counted in the host processes; boot and recovery times; then
    the zombie-partition scenario with ``sgd_task`` hosts.
47. ``native_loader``: ``NativeBatchLoader`` over 65536 x 784 rows: a
    complete, deterministic epoch; batches/s alone and copied to the card.
48. ``serve_quantized``: int8 weights at Llama-3-8B widths (4 layers), dense
    and paged: quantized streams equal the dequantized ones bit for bit,
    exact K4 / K5 counts, bytes and ms a step; the Mixtral-width MoE
    quantized, exact K6-gmm counts.
49. ``hf_import``: ``lm_from_hf`` on a duck-typed GPT-2-small (its
    published config, seeded weights in Hugging Face's layout), served with
    exact K4 and K3-fwd counts.
    After each of 43-49 a ``wall`` line gives its seconds.

Then the kernel summary line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or without the repository around it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import inspect
import json
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 494.7e12      # H100 SXM dense TF32 tensor cores
SEED = 0

GPT2_SMALL = dict(vocab=50257, d_model=768, n_heads=12, n_layers=12,
                  d_ff=3072, max_len=1024, pos_encoding="learned",
                  activation="gelu", norm="layernorm", norm_eps=1e-5,
                  attn_bias=True, ffn_bias=True, tie_embeddings=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_bound_ms(n_bytes: float, n_ops: float):
    """The flash-attention kernels' bound: a float32-accurate product on
    the tensor cores is three TF32 ones (3xTF32), so the operations run at
    494.7 / 3 TFLOP/s; and beside it the float32 SIMT bound (67
    TFLOP/s). ``(ms, "bytes"|"operations", simt_ms)``."""
    ms, by = bound_ms(n_bytes, 3 * n_ops, TF32_OPS_PER_S)
    return ms, by, bound_ms(n_bytes, n_ops)[0]


def device_ms(fn, inputs, n_iter: int = 60) -> float:
    """Mean device time of ``fn(*inputs[i % len(inputs)])`` with CUDA events.
    A device-side sleep first holds the stream while the host enqueues
    every launch, so host overhead between launches does not show up as
    device time. Cycling through several input sets keeps the working set
    larger than the 50 MB L2, as the decode loop's per-layer caches are."""
    for a in inputs[:2]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)   # ~0.1 s at H100 clocks
    start.record()
    for i in range(n_iter):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


# -- phase 1 ---------------------------------------------------------------------


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    first = out.splitlines()[0]
    name, limit = (s.strip() for s in first.split(",", 1))
    return first, name, limit


# -- phase 2 ---------------------------------------------------------------------


def check_layer_norm(card):
    from elephas_tpu_torch.ops.layer_norm import (_ROW_MAX_D, fused_layer_norm,
                                                  layer_norm_reference)

    def route(d):
        """The kernel route a [n, d] call takes (aligned rows: float4 where
        d % 4 == 0)."""
        return (("rows (one warp a row" if d <= _ROW_MAX_D else "wide (one block a row")
                + (", float4)" if d % 4 == 0 else ", scalar)"))

    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED)
    checks, worst = [], 0.0
    for shape, offset in (((8, 768), 0.0), ((128, 768), 0.0),
                          ((8, 1000), 0.0), ((8, 1001), 0.0), ((8, 1025), 0.0),
                          ((8, 768), 1e4)):
        n, d = shape
        x = gen.normal(size=shape).astype(np.float32)
        x[0] += offset
        s = (1 + 0.1 * gen.normal(size=(d,))).astype(np.float32)
        b = gen.normal(size=(d,)).astype(np.float32)
        x, s, b = (torch.from_numpy(a).to(dev) for a in (x, s, b))
        got = fused_layer_norm(x, s, b)
        torch.cuda.synchronize()
        if offset:
            # a row at 1e4: float32 row means round differently in any two
            # implementations, so the plain version runs in float64 here
            want = layer_norm_reference(x.double(), s.double(), b.double())
        else:
            want = layer_norm_reference(x, s, b).float()
        err = float((got.double() - want.double()).abs().max())
        require(bool(torch.isfinite(got).all()), f"layer_norm {shape} not finite")
        require(err <= 1e-5, f"layer_norm {shape} offset {offset}: "
                             f"max abs err {err} > 1e-5")
        worst = max(worst, err)
        require(torch.equal(fused_layer_norm(x, s, b), got),
                f"layer_norm {shape}: two launches differ")
        checks.append({"shape": list(shape), "route": route(d), "row_offset": offset,
                       "max_abs_err": err, "atol": 1e-5, "same_bits": True})

    def timed(n, d):
        """Kernel, plain, ``F.layer_norm`` and bound at ``[n, d]``, cycling
        through four input sets (at the training shape 100 MB of rows, out
        of the 50 MB L2)."""
        sets = [tuple(t.to(dev) for t in (torch.randn(n, d), 1 + 0.1 * torch.randn(d),
                                          torch.randn(d))) for _ in range(4)]
        ms = device_ms(fused_layer_norm, sets)
        plain_ms = device_ms(lambda x, s, b: layer_norm_reference(x, s, b).float(), sets)
        lib_ms = device_ms(lambda x, s, b: torch.nn.functional.layer_norm(x, (d,), s, b, 1e-5),
                           sets)
        return (ms, plain_ms, lib_ms, *bound_ms((2 * n * d + 2 * d) * 4, 8 * n * d))

    # at the decode shape [8, 768] (2L+1 launches a decode step) and the GPT-2
    # training shape [8192, 768] (B 8 x T 1024 rows, 2L+1 launches a step)
    ms, plain_ms, lib_ms, bms, by = timed(8, 768)
    train = dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                     timed(8192, 768)))
    row = {"name": "layer_norm_fwd", "route": "cuda",
           "source": "elephas_tpu_torch/ops/csrc/layer_norm.cu",
           "replaces": "elephas_tpu/ops/layer_norm.py:115",
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "timed_shape": [8, 768], "timed_route": route(768),
           "train_shape": [8192, 768], "train_route": route(768),
           **{f"train_{k}": v for k, v in train.items()}}
    emit({"phase": "kernel", "kernel": "layer_norm_fwd", "checks": checks,
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": bms, "bound_by": by, "timed_route": route(768),
          "train_shape": [8192, 768], "train": train, "train_route": route(768),
          "card": card})
    return row


def _allclose_err(got, want, tol):
    """``(max abs error, ok)`` of ``got`` against ``want`` under
    ``|got - want| <= tol + tol * |want|`` (the reference tests' allclose
    with atol = rtol = tol)."""
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= tol + tol * w.abs()).all())


def check_layer_norm_bwd(card):
    """K3-bwd against the autograd backward of the plain version on both of
    its routes: one warp a row with the row in registers (D up to 1024:
    the train phase's B*T rows at 768, the limit 1024, a width of no
    multiple of 4, a row count that leaves a block's 4 warps uneven) and
    one block a row (1025, 2048); rows at 1e4 on both routes (against the
    plain version in float64: a float32 row mean rounds visibly there);
    each case run twice for the same bits."""
    from elephas_tpu_torch.ops.layer_norm import (_ROW_MAX_D, fused_layer_norm_bwd,
                                                  layer_norm_reference)

    dev = torch.device("cuda")
    gen = np.random.default_rng(SEED + 5)
    tol = 1e-4   # the reference's own pin for these gradients
    checks, worst = [], 0.0

    def plain_grads(x, s, b, g):
        x, s, b = (t.detach().requires_grad_() for t in (x, s, b))
        return torch.autograd.grad(layer_norm_reference(x, s, b), (x, s, b), g)

    def inputs(n, d, offset=0.0):
        x = (gen.normal(size=(n, d)) * 3 + 1).astype(np.float32)
        x[0] += offset
        s = (1 + 0.1 * gen.normal(size=(d,))).astype(np.float32)
        b = gen.normal(size=(d,)).astype(np.float32)
        g = gen.normal(size=(n, d)).astype(np.float32)
        return tuple(torch.from_numpy(a).to(dev) for a in (x, s, b, g))

    for shape, offset in (((8192, 768), 0.0), ((8, 1000), 0.0), ((8, 1001), 0.0),
                          ((1100, 768), 0.0), ((64, 1024), 0.0), ((64, 1025), 0.0),
                          ((64, 2048), 0.0), ((8, 768), 1e4), ((8, 2048), 1e4)):
        x, s, b, g = inputs(*shape, offset)
        got = fused_layer_norm_bwd(x, s, g)
        again = fused_layer_norm_bwd(x, s, g)
        torch.cuda.synchronize()
        require(all(torch.equal(a, w) for a, w in zip(got, again)),
                f"layer_norm_bwd {shape}: two runs differ")
        if offset:
            want = plain_grads(x.double(), s.double(), b.double(), g.double())
        else:
            want = plain_grads(x, s, b, g)
        errs = [_allclose_err(a, w, tol) for a, w in zip(got, want)]
        err = max(e for e, _ in errs)
        for name, a in zip(("dx", "dscale", "dbias"), got):
            require(bool(torch.isfinite(a).all()), f"layer_norm_bwd {shape}: {name} not finite")
        require(all(ok for _, ok in errs),
                f"layer_norm_bwd {shape} offset {offset}: max abs err {err} "
                f"beyond atol = rtol = {tol}")
        worst = max(worst, err)
        checks.append({"shape": list(shape), "row_offset": offset,
                       "route": "rows" if shape[1] <= _ROW_MAX_D else "wide",
                       "max_abs_err": err, "atol": tol, "rtol": tol,
                       "same_bits_twice": True})

    # timing at the train phase's shape [B*T, D] = [8192, 768]; 4 input
    # sets of 50 MB each keep the reads out of the 50 MB L2
    n, d = 8192, 768
    sets = [inputs(n, d) for _ in range(4)]
    ms = device_ms(lambda x, s, b, g: fused_layer_norm_bwd(x, s, g), sets, n_iter=40)

    def autograd_ms(fwd):
        graphs = []
        for x, s, b, g in sets:
            x, s, b = (t.detach().requires_grad_() for t in (x, s, b))
            graphs.append((fwd(x, s, b), (x, s, b), g))
        return device_ms(lambda out, args, g: torch.autograd.grad(
            out, args, g, retain_graph=True), graphs, n_iter=40)

    plain_ms = autograd_ms(layer_norm_reference)
    lib_ms = autograd_ms(lambda x, s, b: torch.nn.functional.layer_norm(x, (d,), s, b, 1e-5))
    bms, by = bound_ms((3 * n * d + 3 * d) * 4, 12 * n * d)
    row = {"name": "layer_norm_bwd", "route": "cuda",
           "source": "elephas_tpu_torch/ops/csrc/layer_norm.cu",
           "replaces": "elephas_tpu/ops/layer_norm.py:146",
           "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "library": "autograd backward of F.layer_norm",
           "timed_shape": [n, d]}
    emit({"phase": "kernel", "kernel": "layer_norm_bwd", "checks": checks,
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": bms, "bound_by": by, "card": card})
    return row


# name, B, H, Hkv, T, Dh, causal, window, dtype, lse cotangent, tolerance:
# float32 at the reference's own pin for these kernels (atol = rtol =
# 2e-5, tests/ops/test_pallas_flash.py:50), bfloat16 at its bf16 pin (2e-2,
# :70): the kernel rounds its outputs to bf16, the plain version rounds
# once from its float32 result
K2_CASES = [
    ("gpt2_train_f32", 8, 12, 12, 1024, 64, True, None, torch.float32, False, 2e-5),
    ("t1000_f32", 2, 12, 12, 1000, 64, True, None, torch.float32, False, 2e-5),
    ("gqa_h8_hkv2_dh128_f32", 2, 8, 2, 1024, 128, True, None, torch.float32, False, 2e-5),
    ("window128_f32", 2, 12, 12, 1024, 64, True, 128, torch.float32, False, 2e-5),
    ("noncausal_f32", 2, 12, 12, 1024, 64, False, None, torch.float32, False, 2e-5),
    ("with_lse_f32", 2, 12, 12, 512, 64, True, None, torch.float32, True, 2e-5),
    ("bf16_dh64", 2, 12, 12, 1024, 64, True, None, torch.bfloat16, False, 2e-2),
    ("bf16_dh256", 2, 4, 4, 512, 256, True, None, torch.bfloat16, False, 2e-2),
]


def _attn_inputs(gen, B, H, Hkv, T, Dh, dtype):
    dev = torch.device("cuda")

    def t(*shape):
        return torch.from_numpy(gen.normal(size=shape).astype(np.float32)).to(dev, dtype)

    return t(B, T, H, Dh), t(B, T, Hkv, Dh), t(B, T, Hkv, Dh), t(B, T, H, Dh)


def _visible_pairs(T, causal, window):
    """(query, key) pairs the causal bound and the window leave visible."""
    if not causal:
        return T * T
    if window is None or window >= T:
        return T * (T + 1) // 2
    return sum(min(i + 1, window) for i in range(T))


def _bwd_f64(q, k, v, do, lse, delta, causal, window):
    """The plain backward's math in float64 from the same inputs, lse and
    delta: the oracle that the kernels and the plain float32 version are
    both measured against. ``(dq, dk, dv)`` float64."""
    from elephas_tpu_torch.ops.flash_attention import _visible, repeat_kv_heads

    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    q, k, v, do = (t.double() for t in (q, k, v, do))
    kr, vr = repeat_kv_heads(k, H), repeat_kv_heads(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr) * Dh ** -0.5
    keep = _visible(T, T, causal, window, q.device)
    if keep is not None:
        s = s.masked_fill_(~keep, float("-inf"))
    p = torch.exp_(s.sub_(lse.double()[..., None]))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = torch.einsum("bqhd,bkhd->bhqk", do, vr).sub_(delta.double()[..., None])
    ds = ds.mul_(p).mul_(Dh ** -0.5)
    del p
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    if Hkv != H:
        dk = dk.reshape(B, T, Hkv, H // Hkv, Dh).sum(dim=3)
        dv = dv.reshape(B, T, Hkv, H // Hkv, Dh).sum(dim=3)
    return dq, dk, dv


def _fwd_f64(q, k, v, causal, window):
    """The plain forward's math in float64: the oracle of the kernel's and
    the plain float32 version's ``(o, lse)``."""
    from elephas_tpu_torch.ops.flash_attention import _visible, repeat_kv_heads

    T, H, Dh = q.shape[1], q.shape[2], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), repeat_kv_heads(k, H).double())
    s = s.mul_(Dh ** -0.5)
    keep = _visible(T, T, causal, window, q.device)
    if keep is not None:
        s = s.masked_fill_(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp_(s.sub_(lse[..., None]))
    return torch.einsum("bhqk,bkhd->bqhd", p, repeat_kv_heads(v, H).double()), lse


def _rot_f64(x, c2, s2, neg=False):
    """Half-split RoPE in float64 (``_rope_apply``'s formula)."""
    c, s = c2.double()[:, :, None, :], s2.double()[:, :, None, :]
    x = x.double()
    return x * c + torch.roll(x, x.shape[-1] // 2, dims=-1) * (-s if neg else s)


def _oracle_errors(got, plain, oracle):
    """Max abs errors of the kernels' outputs (o, lse, dq, dk, dv) and the
    plain version's against the float64 oracle."""
    def errs(ts):
        return {n: float((t.double() - o).abs().max()) for n, t, o in
                zip(("o", "lse", "dq", "dk", "dv"), ts, oracle)}
    return {"kernel": errs(got), "plain": errs(plain)}


def check_flash_attention(card):
    """K2-fwd, K2-dq and K2-dkv against their plain versions on the same
    inputs (the backward kernels and the plain backward get the same lse
    and delta), for every case of ``K2_CASES``; with an lse cotangent also
    the whole differentiable ``flash_attention_with_lse`` against autograd
    of the plain forward. Then timed at the GPT-2 training shape."""
    from elephas_tpu_torch.ops.flash_attention import (
        attention_bwd_reference, attention_fwd_reference, flash_attention_dkv,
        flash_attention_dq, flash_attention_fwd, flash_attention_with_lse)

    gen = np.random.default_rng(SEED + 3)
    checks = []
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, B, H, Hkv, T, Dh, causal, window, dtype, with_lse, tol in K2_CASES:
        q, k, v, do = _attn_inputs(gen, B, H, Hkv, T, Dh, dtype)
        g_lse = (torch.from_numpy(gen.normal(size=(B, H, T)).astype(np.float32)).cuda()
                 if with_lse else torch.zeros(B, H, T, device="cuda"))
        o, lse = flash_attention_fwd(q, k, v, causal, window)
        o_again, lse_again = flash_attention_fwd(q, k, v, causal, window)
        wo, wl = attention_fwd_reference(q, k, v, causal, window)
        delta = ((do.float() * wo.float()).sum(-1).transpose(1, 2) - g_lse).contiguous()
        dq = flash_attention_dq(q, k, v, do, wl, delta, causal, window)
        dk, dv = flash_attention_dkv(q, k, v, do, wl, delta, causal, window)
        again = (flash_attention_dq(q, k, v, do, wl, delta, causal, window),
                 *flash_attention_dkv(q, k, v, do, wl, delta, causal, window))
        want = attention_bwd_reference(q, k, v, do, wl, delta, causal, window)
        torch.cuda.synchronize()
        require(torch.equal(o, o_again) and torch.equal(lse, lse_again),
                f"flash_attention {name}: two runs of the forward differ")
        require(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
                f"flash_attention {name}: two runs of dq/dkv differ")
        oracle = _oracle_errors((o, lse, dq, dk, dv), (wo, wl, *want),
                                (*_fwd_f64(q, k, v, causal, window),
                                 *_bwd_f64(q, k, v, do, wl, delta, causal, window)))
        del again, o_again, lse_again
        errs = {"o": _allclose_err(o, wo, tol), "lse": _allclose_err(lse, wl, tol),
                "dq": _allclose_err(dq, want[0], tol),
                "dk": _allclose_err(dk, want[1], tol),
                "dv": _allclose_err(dv, want[2], tol)}
        if with_lse:
            # the autograd Function end to end (kernels, delta, lse
            # cotangent) against autograd through the plain forward
            gl = g_lse.transpose(1, 2)
            grads = {}
            for route in ("kernel", "plain"):
                args = [t.detach().requires_grad_() for t in (q, k, v)]
                if route == "kernel":
                    out, lse_bth = flash_attention_with_lse(*args, causal=causal)
                else:
                    out, lse_bht = attention_fwd_reference(*args, causal, window)
                    lse_bth = lse_bht.transpose(1, 2)
                loss = (out.float() * do.float()).sum() + (lse_bth * gl).sum()
                grads[route] = torch.autograd.grad(loss, args)
            for n_, a, w in zip(("autograd_dq", "autograd_dk", "autograd_dv"),
                                grads["kernel"], grads["plain"]):
                errs[n_] = _allclose_err(a, w, tol)
        bad = [k_ for k_, (_, ok) in errs.items() if not ok]
        require(not bad, f"flash_attention {name}: {bad} beyond atol = rtol = {tol}: "
                         f"{ {k_: e for k_, (e, _) in errs.items()} }")
        if dtype == torch.float32:
            worst["fwd"] = max(worst["fwd"], errs["o"][0], errs["lse"][0])
            worst["dq"] = max(worst["dq"], errs["dq"][0])
            worst["dkv"] = max(worst["dkv"], errs["dk"][0], errs["dv"][0])
        checks.append({"case": name, "B": B, "H": H, "Hkv": Hkv, "T": T, "Dh": Dh,
                       "causal": causal, "window": window, "dtype": str(dtype),
                       "lse_cotangent": with_lse, "atol": tol, "rtol": tol,
                       "max_abs_err": {k_: e for k_, (e, _) in errs.items()},
                       "oracle_f64_max_abs_err": oracle, "bitwise_repeat": True})
        del q, k, v, do, o, lse, wo, wl, delta, dq, dk, dv, want

    # timing at the GPT-2 training shape, float32, causal; two input sets
    # (100 MB each) alternate so the reads miss the 50 MB L2
    B, H, T, Dh = 8, 12, 1024, 64
    sets = []
    for _ in range(2):
        q, k, v, do = _attn_inputs(gen, B, H, H, T, Dh, torch.float32)
        o, lse = attention_fwd_reference(q, k, v, True)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        sets.append((q, k, v, do, lse, delta))
    n = 20
    fwd_ms = device_ms(lambda q, k, v, *_: flash_attention_fwd(q, k, v, True), sets, n)
    dq_ms = device_ms(lambda *a: flash_attention_dq(*a, True), sets, n)
    dkv_ms = device_ms(lambda *a: flash_attention_dkv(*a, True), sets, n)
    plain_fwd_ms = device_ms(lambda q, k, v, *_: attention_fwd_reference(q, k, v, True), sets, n)
    plain_bwd_ms = device_ms(lambda *a: attention_bwd_reference(*a, True), sets, n)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s[:4]) for s in sets]
    lib_fwd_ms = device_ms(lambda q, k, v, _: sdpa(q, k, v, is_causal=True), lib_sets, n)
    graphs = []
    for q, k, v, do in lib_sets:
        args = [t.detach().requires_grad_() for t in (q, k, v)]
        graphs.append((sdpa(*args, is_causal=True), args, do))
    lib_bwd_ms = device_ms(lambda out, args, do: torch.autograd.grad(
        out, args, do, retain_graph=True), graphs, n)
    del sets, lib_sets, graphs

    pairs = B * H * _visible_pairs(T, True, None)
    tensor = B * T * H * Dh * 4                       # one [B, T, H, Dh] f32 array
    stat = B * H * T * 4                              # one [B, H, T] f32 array
    rows = []
    for name, ms, plain_ms, lib_ms, lib, n_bytes, n_ops, err in (
            ("flash_attention_fwd", fwd_ms, plain_fwd_ms, lib_fwd_ms,
             "F.scaled_dot_product_attention(is_causal=True)",
             4 * tensor + stat, 4 * Dh * pairs, worst["fwd"]),
            ("flash_attention_dq", dq_ms, plain_bwd_ms, lib_bwd_ms,
             "autograd backward of F.scaled_dot_product_attention (dq, dk and dv together)",
             5 * tensor + 2 * stat, 6 * Dh * pairs, worst["dq"]),
            ("flash_attention_dkv", dkv_ms, plain_bwd_ms, None, None,
             6 * tensor + 2 * stat, 8 * Dh * pairs, worst["dkv"])):
        bms, by, simt_ms = k2_bound_ms(n_bytes, n_ops)
        rows.append({"name": name, "route": "cuda",
                     "source": "elephas_tpu_torch/ops/csrc/flash_attention.cu",
                     "replaces": ("elephas_tpu/ops/pallas_flash.py:211" if name.endswith("fwd")
                                  else "elephas_tpu/ops/pallas_flash.py:414"),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "plain": ("attention_fwd_reference" if name.endswith("fwd") else
                               "attention_bwd_reference (dq, dk and dv together)"),
                     "bound_ms": bms, "bound_by": by, "bound_simt_ms": simt_ms,
                     "library_ms": lib_ms, "library": lib,
                     "timed_shape": {"B": B, "H": H, "Hkv": H, "T": T, "Dh": Dh,
                                     "causal": True, "dtype": "float32"}})
    emit({"phase": "kernel", "kernel": "flash_attention", "checks": checks,
          "timing": [{k_: r[k_] for k_ in ("name", "ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by", "bound_simt_ms")}
                     for r in rows],
          "card": card})
    return rows


# Llama-3-8B attention at its training shape, then the edges: ragged T, GQA
# at Dh 64, a window, bf16, and tables at per-row position offsets
ROPE_CASES = [
    # name, B, H, Hkv, T, Dh, window, dtype, first position, tol
    ("llama3_8b_train_f32", 4, 32, 8, 2048, 128, None, torch.float32, 0, 2e-5),
    ("t1000_f32", 2, 32, 8, 1000, 128, None, torch.float32, 0, 2e-5),
    ("gqa_h8_hkv2_dh64_f32", 2, 8, 2, 1024, 64, None, torch.float32, 0, 2e-5),
    ("window128_f32", 2, 32, 8, 1024, 128, 128, torch.float32, 0, 2e-5),
    ("bf16_dh128", 2, 32, 8, 1024, 128, None, torch.bfloat16, 0, 2e-2),
    ("offset4096_f32", 2, 8, 2, 512, 128, None, torch.float32, 4096, 2e-5),
]
LLAMA_THETA = 500000.0


def _rope_tables(B, T, Dh, first=0):
    """The model's tables for rows at positions ``first + 37 b + t``."""
    from elephas_tpu_torch.models.transformer import _rope_angles
    from elephas_tpu_torch.ops.flash_attention import make_rope_tables

    pos = (first + 37 * torch.arange(B, device="cuda")[:, None]
           + torch.arange(T, device="cuda")[None, :])
    return make_rope_tables(*_rope_angles(pos, Dh, LLAMA_THETA))


def check_flash_attention_rope(card):
    """The rope-on-load K2-fwd, K2-dq and K2-dkv against their plain
    versions (rotate in float32, attend, derotate dq and dk) on the same
    inputs, lse and delta, over ``ROPE_CASES``, and the autograd Function
    against autograd through the plain forward. Then timed at the Llama-3-8B
    training shape beside the plain versions and two compositions of two
    PyTorch operations each (no single PyTorch call computes rope and
    attention together): (a) ``_rope_rotate`` of q and k, then the plain
    K2 kernels, the path the model took before; (b) ``_rope_rotate``, then
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)``;
    forward, and each one's autograd backward (dq, dk and dv together)."""
    from elephas_tpu_torch.models.transformer import _rope_rotate
    from elephas_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_rope, flash_attention_rope_dkv,
        flash_attention_rope_dq, flash_attention_rope_fwd,
        rope_attention_bwd_reference, rope_attention_fwd_reference)

    gen = np.random.default_rng(SEED + 30)
    checks = []
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, B, H, Hkv, T, Dh, window, dtype, first, tol in ROPE_CASES:
        q, k, v, do = _attn_inputs(gen, B, H, Hkv, T, Dh, dtype)
        c2, s2 = _rope_tables(B, T, Dh, first)
        o, lse = flash_attention_rope_fwd(q, k, v, c2, s2, True, window)
        o_again, lse_again = flash_attention_rope_fwd(q, k, v, c2, s2, True, window)
        wo, wl = rope_attention_fwd_reference(q, k, v, c2, s2, True, window)
        delta = (do.float() * wo.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, wl, delta, c2, s2, True, window)
        dq = flash_attention_rope_dq(*bwd)
        dk, dv = flash_attention_rope_dkv(*bwd)
        again = (flash_attention_rope_dq(*bwd), *flash_attention_rope_dkv(*bwd))
        want = rope_attention_bwd_reference(*bwd)
        torch.cuda.synchronize()
        require(torch.equal(o, o_again) and torch.equal(lse, lse_again),
                f"flash_attention_rope {name}: two runs of the forward differ")
        require(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
                f"flash_attention_rope {name}: two runs of dq/dkv differ")
        del again, o_again, lse_again
        qr64, kr64 = _rot_f64(q, c2, s2), _rot_f64(k, c2, s2)
        f64 = _fwd_f64(qr64, kr64, v, True, window)
        o64 = _bwd_f64(qr64, kr64, v, do, wl, delta, True, window)
        oracle = _oracle_errors((o, lse, dq, dk, dv), (wo, wl, *want), (
            *f64, _rot_f64(o64[0], c2, s2, neg=True), _rot_f64(o64[1], c2, s2, neg=True),
            o64[2]))
        del o64, f64, qr64, kr64
        errs = {"o": _allclose_err(o, wo, tol), "lse": _allclose_err(lse, wl, tol),
                "dq": _allclose_err(dq, want[0], tol),
                "dk": _allclose_err(dk, want[1], tol),
                "dv": _allclose_err(dv, want[2], tol)}
        del o, lse, dq, dk, dv, want
        if T <= 1024:
            # the autograd Function end to end against autograd through
            # the plain forward (which differentiates the rotation itself)
            grads = {}
            for route in ("kernel", "plain"):
                args = [t.detach().requires_grad_() for t in (q, k, v)]
                out = (flash_attention_rope(*args, c2, s2, True, window=window)
                       if route == "kernel" else
                       rope_attention_fwd_reference(*args, c2, s2, True, window)[0])
                grads[route] = torch.autograd.grad((out.float() * do.float()).sum(), args)
            for n_, a, w in zip(("autograd_dq", "autograd_dk", "autograd_dv"),
                                grads["kernel"], grads["plain"]):
                errs[n_] = _allclose_err(a, w, tol)
        bad = [k_ for k_, (_, ok) in errs.items() if not ok]
        require(not bad, f"flash_attention_rope {name}: {bad} beyond atol = rtol = "
                         f"{tol}: { {k_: e for k_, (e, _) in errs.items()} }")
        if dtype == torch.float32:
            worst["fwd"] = max(worst["fwd"], errs["o"][0], errs["lse"][0])
            worst["dq"] = max(worst["dq"], errs["dq"][0])
            worst["dkv"] = max(worst["dkv"], errs["dk"][0], errs["dv"][0])
        checks.append({"case": name, "B": B, "H": H, "Hkv": Hkv, "T": T, "Dh": Dh,
                       "causal": True, "window": window, "dtype": str(dtype),
                       "first_position": first, "theta": LLAMA_THETA,
                       "atol": tol, "rtol": tol,
                       "max_abs_err": {k_: e for k_, (e, _) in errs.items()},
                       "oracle_f64_max_abs_err": oracle, "bitwise_repeat": True})
        del q, k, v, do, wo, wl, delta, bwd, c2, s2
    torch.cuda.empty_cache()

    # timing at the Llama-3-8B training shape, float32, causal; two input
    # sets (about 340 MB each) alternate so the reads miss the 50 MB L2
    B, H, Hkv, T, Dh = 4, 32, 8, 2048, 128
    sets = []
    for _ in range(2):
        q, k, v, do = _attn_inputs(gen, B, H, Hkv, T, Dh, torch.float32)
        c2, s2 = _rope_tables(B, T, Dh)
        o, lse = rope_attention_fwd_reference(q, k, v, c2, s2, True)
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        sets.append((q, k, v, do, lse, delta, c2, s2))
        del o
    n = 10
    fwd_ms = device_ms(lambda q, k, v, do, lse, delta, c2, s2:
                       flash_attention_rope_fwd(q, k, v, c2, s2, True), sets, n)
    dq_ms = device_ms(lambda *a: flash_attention_rope_dq(*a, True), sets, n)
    dkv_ms = device_ms(lambda *a: flash_attention_rope_dkv(*a, True), sets, n)
    plain_fwd_ms = device_ms(lambda q, k, v, do, lse, delta, c2, s2:
                             rope_attention_fwd_reference(q, k, v, c2, s2, True), sets, 4)
    plain_bwd_ms = device_ms(lambda *a: rope_attention_bwd_reference(*a, True), sets, 4)

    def rotated(s):
        q, k, v, do, _, _, c2, s2 = s
        cos, sin = c2[:, :, None, : Dh // 2], s2[:, :, None, Dh // 2:]
        return q, k, v, do, cos, sin

    sdpa = torch.nn.functional.scaled_dot_product_attention

    def old_path(q, k, v, cos, sin):     # (a): rotate, then the plain K2
        return flash_attention(_rope_rotate(q, cos, sin), _rope_rotate(k, cos, sin), v,
                               True)

    def sdpa_path(q, k, v, cos, sin):    # (b): rotate, then SDPA
        return sdpa(_rope_rotate(q, cos, sin).transpose(1, 2),
                    _rope_rotate(k, cos, sin).transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True).transpose(1, 2)

    rot_sets = [rotated(s) for s in sets]
    compositions = {}
    for label, fn in (("rope_rotate_then_k2", old_path),
                      ("rope_rotate_then_sdpa", sdpa_path)):
        with torch.no_grad():
            f_ms = device_ms(lambda q, k, v, do, cos, sin: fn(q, k, v, cos, sin),
                             rot_sets, n)
        graphs = []
        for q, k, v, do, cos, sin in rot_sets:
            args = [t.detach().requires_grad_() for t in (q, k, v)]
            graphs.append((fn(*args, cos, sin), args, do))
        b_ms = device_ms(lambda out, args, do: torch.autograd.grad(
            out, args, do, retain_graph=True), graphs, n)
        compositions[label] = {"fwd_ms": f_ms, "bwd_ms": b_ms}
        del graphs
    del sets, rot_sets

    pairs = B * H * _visible_pairs(T, True, None)
    qb = B * T * H * Dh * 4                           # q, o, dO, dq (f32)
    kb = B * T * Hkv * Dh * 4                         # k, v, dk, dv
    stat = B * H * T * 4                              # lse, delta
    tab = 2 * B * T * Dh * 4                          # c2 and s2
    rot_q, rot_k = 3 * B * T * H * Dh, 3 * B * T * Hkv * Dh   # 2 mul + 1 add an element
    rows = []
    for name, ms, plain_ms, comp, n_bytes, n_ops, err in (
            ("flash_attention_rope_fwd", fwd_ms, plain_fwd_ms, "fwd_ms",
             2 * qb + 2 * kb + stat + tab, 4 * Dh * pairs + rot_q + rot_k, worst["fwd"]),
            ("flash_attention_rope_dq", dq_ms, plain_bwd_ms, "bwd_ms",
             3 * qb + 2 * kb + 2 * stat + tab, 6 * Dh * pairs + 2 * rot_q + rot_k,
             worst["dq"]),
            ("flash_attention_rope_dkv", dkv_ms, plain_bwd_ms, "bwd_ms",
             2 * qb + 4 * kb + 2 * stat + tab, 8 * Dh * pairs + rot_q + 2 * rot_k,
             worst["dkv"])):
        bms, by, simt_ms = k2_bound_ms(n_bytes, n_ops)
        rows.append({"name": name, "route": "cuda",
                     "source": "elephas_tpu_torch/ops/csrc/flash_attention.cu",
                     "replaces": ("elephas_tpu/ops/pallas_flash.py:211" if name.endswith("fwd")
                                  else "elephas_tpu/ops/pallas_flash.py:414"),
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "plain": ("rope_attention_fwd_reference" if name.endswith("fwd") else
                               "rope_attention_bwd_reference (dq, dk and dv together)"),
                     "bound_ms": bms, "bound_by": by, "bound_simt_ms": simt_ms,
                     "library_ms": None,
                     "library": "none: no single PyTorch call computes rope and attention",
                     "two_op_compositions_ms": {
                         k_: v_[comp] for k_, v_ in compositions.items()},
                     "compositions_compute": ("forward" if comp == "fwd_ms" else
                                              "autograd backward: dq, dk and dv together"),
                     "timed_shape": {"B": B, "H": H, "Hkv": Hkv, "T": T, "Dh": Dh,
                                     "causal": True, "dtype": "float32",
                                     "theta": LLAMA_THETA}})
    emit({"phase": "kernel", "kernel": "flash_attention_rope", "checks": checks,
          "timing": [{k_: r[k_] for k_ in ("name", "ms", "plain_ms", "library_ms",
                                           "two_op_compositions_ms", "bound_ms",
                                           "bound_by", "bound_simt_ms")} for r in rows],
          "card": card})
    return rows


# the decode position sets K4 and K5-decode are timed at: 15-1023 with
# page-edge values (15, 16, 511, 512), and the serve mix's (prompts of
# 32-256 tokens plus up to 64 new)
PAGED_GPT2_POS = [31, 15, 16, 511, 512, 700, 1000, 1023]
SERVE_POS = [32, 64, 100, 150, 200, 256, 288, 320]


def _decode_inputs(gen, B, hkv, g, dh, T, dtype, pos):
    dev = torch.device("cuda")
    q = torch.from_numpy(gen.normal(size=(B, hkv, g, dh)).astype(np.float32)).to(dev)
    k = torch.from_numpy(gen.normal(size=(B, hkv, T, dh)).astype(np.float32)).to(dev, dtype)
    v = torch.from_numpy(gen.normal(size=(B, hkv, T, dh)).astype(np.float32)).to(dev, dtype)
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device=dev)


def _visible(pos, T, window=None, ring=False):
    """Cache slots each row attends (what the kernel must read)."""
    out = []
    for p in pos:
        if ring:
            out.append(min(window, p + 1, T))
        else:
            hi = min(p, T - 1) + 1
            lo = 0 if window is None else max(0, p - window + 1)
            out.append(max(0, hi - lo))
    return out


def check_flash_decode(card):
    from elephas_tpu_torch.ops.flash_decode import (
        decode_attention_reference_lse, flash_decode_lse)

    gen = np.random.default_rng(SEED + 1)
    T = 1024
    gpt2_pos = [0, 1023] + [int(p) for p in gen.integers(0, T, size=6)]
    cases = [
        ("gpt2_f32", dict(B=8, hkv=12, g=1, dh=64, T=T), torch.float32, gpt2_pos, None, False, 1e-5),
        ("gqa_f32", dict(B=4, hkv=8, g=4, dh=128, T=T), torch.float32, [0, 511, 700, 1023], None, False, 1e-5),
        ("window_f32", dict(B=8, hkv=12, g=1, dh=64, T=T), torch.float32, gpt2_pos, 128, False, 1e-5),
        ("ring_f32", dict(B=6, hkv=4, g=2, dh=64, T=256), torch.float32, [0, 100, 255, 256, 700, 1023], 200, True, 1e-5),
        ("window_past_T_f32", dict(B=8, hkv=4, g=2, dh=64, T=256), torch.float32, [256, 260, 280, 300, 320, 340, 350, 354], 100, False, 1e-5),
        ("gpt2_bf16", dict(B=8, hkv=12, g=1, dh=64, T=T), torch.bfloat16, gpt2_pos, None, False, 2e-2),
        ("gqa_bf16", dict(B=4, hkv=8, g=4, dh=128, T=T), torch.bfloat16, [0, 511, 700, 1023], None, False, 2e-2),
    ]
    checks, worst = [], 0.0
    for name, shp, dtype, pos, window, ring, tol in cases:
        q, k, v, pos_t = _decode_inputs(gen, shp["B"], shp["hkv"], shp["g"],
                                        shp["dh"], shp["T"], dtype, pos)
        o, lse = flash_decode_lse(q, k, v, pos_t, window=window, ring=ring)
        torch.cuda.synchronize()
        wo, wl = decode_attention_reference_lse(q, k, v, pos_t, window, ring)
        err = max(float((o - wo).abs().max()), float((lse - wl).abs().max()))
        require(err <= tol, f"flash_decode {name}: max abs err {err} > {tol}")
        worst = max(worst, err) if dtype == torch.float32 else worst
        checks.append({"case": name, "shape": shp, "dtype": str(dtype),
                       "pos": pos, "window": window, "ring": ring,
                       "max_abs_err": err, "atol": tol})

    # timing at the GPT-2-small decode shape, float32 cache, at the three
    # position sets K5-decode is timed at (check_paged_attention); 8 copies
    # of the cache (400 MB) so reads miss the L2
    B, hkv, g, dh = 8, 12, 1, 64
    slots = torch.arange(T, device="cuda")

    def time_decode(pos):
        sets = [_decode_inputs(gen, B, hkv, g, dh, T, torch.float32, pos) for _ in range(8)]
        o, lse = flash_decode_lse(*sets[0])
        require(all(torch.equal(a, b) for a, b in zip(flash_decode_lse(*sets[0]), (o, lse))),
                f"flash_decode at {pos}: two launches differ")
        ms = device_ms(lambda q, k, v, p: flash_decode_lse(q, k, v, p), sets)
        plain_ms = device_ms(lambda q, k, v, p: decode_attention_reference_lse(q, k, v, p),
                             sets)
        lib_sets = [s[:3] + ((slots[None, :] <= s[3][:, None].long())[:, None, None, :],)
                    for s in sets]
        lib_ms = device_ms(lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=m), lib_sets)
        del sets, lib_sets
        vis = sum(_visible(pos, T))
        n_bytes = vis * hkv * dh * 2 * 4 + (2 * B * hkv * g * dh + B * hkv * g + B) * 4
        bms, by = bound_ms(n_bytes, vis * hkv * g * dh * 4)
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
                "bound_by": by, "pos": pos}

    timed = {"gpt2_pos": time_decode(PAGED_GPT2_POS), "serve_pos": time_decode(SERVE_POS),
             "full_cache": time_decode([T - 1] * B)}
    at = timed["gpt2_pos"]
    row = {"name": "flash_decode_lse", "route": "cuda",
           "source": "elephas_tpu_torch/ops/csrc/flash_decode.cu",
           "replaces": "elephas_tpu/ops/flash_decode.py:217",
           "max_abs_err": worst, "ms": at["ms"], "plain_ms": at["plain_ms"],
           "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
           "library_ms": at["library_ms"],
           "library": "F.scaled_dot_product_attention with an explicit mask",
           "timed_shape": {"B": B, "Hkv": hkv, "G": g, "Dh": dh, "T": T,
                           "pos": PAGED_GPT2_POS, "kv_dtype": "float32"},
           "by_positions": timed}
    emit({"phase": "kernel", "kernel": "flash_decode_lse", "checks": checks,
          "by_positions": timed, "card": card})
    return row


def _paged_inputs(gen, S, hkv, g, dh, page, M, dtype, pos, C=None):
    """q, a pool of S*M + 1 pages (page 0 the trash page, filled with 1e4:
    finite garbage that must never reach an output) and a table mapping
    each slot's live pages to a random permutation of pool pages; cells
    past the last position a slot can see stay 0 (unmapped), as the
    engine leaves them."""
    dev = torch.device("cuda")
    P = S * M + 1
    kp = gen.normal(size=(P, hkv, page, dh)).astype(np.float32)
    vp = gen.normal(size=(P, hkv, page, dh)).astype(np.float32)
    kp[0] = vp[0] = 1e4
    table = (1 + gen.permutation(S * M)).reshape(S, M).astype(np.int32)
    last = np.asarray(pos) + (0 if C is None else C - 1)
    for s in range(S):
        table[s, last[s] // page + 1:] = 0
    shape = (S, hkv, g, dh) if C is None else (S, hkv, g, C, dh)
    q = gen.normal(size=shape).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    return (t(q), t(kp).to(dtype), t(vp).to(dtype), t(table),
            torch.tensor(np.asarray(pos), dtype=torch.int32, device=dev))


def _dense_view(kp, vp, table, page):
    from elephas_tpu_torch.ops.paged_attention import paged_view_rows

    return paged_view_rows(kp, table, page), paged_view_rows(vp, table, page)


def check_paged_attention(card):
    """K5-decode and K5-chunk against their plain versions (which gather
    the table's view and run the dense plain attention) on the same pool,
    table and positions; then timed at the serving decode shape and the
    prefill insert shape. Tolerance: atol = rtol = 2e-5 in float32 (the
    reference's pin for K2/K4) and for K5-chunk with a bf16 pool too (the
    plain version widens it to float32, and a bf16 value is exact in the
    kernel's TF32 products), 2e-2 for K5-decode with a bf16 pool."""
    from elephas_tpu_torch.ops.paged_attention import (
        paged_chunk_reference, paged_decode_reference_lse, paged_flash_chunk,
        paged_flash_decode_lse)

    gen = np.random.default_rng(SEED + 8)
    f32, bf16 = torch.float32, torch.bfloat16
    gpt2_pos = PAGED_GPT2_POS
    dec_cases = [
        ("gpt2_f32", dict(S=8, hkv=12, g=1, dh=64, page=16, M=64), f32, gpt2_pos, None, 2e-5),
        ("gqa_dh128_f32", dict(S=4, hkv=2, g=4, dh=128, page=16, M=64), f32, [31, 512, 700, 1023], None, 2e-5),
        ("window100_f32", dict(S=8, hkv=12, g=1, dh=64, page=16, M=64), f32, gpt2_pos, 100, 2e-5),
        ("page8_f32", dict(S=8, hkv=12, g=1, dh=64, page=8, M=128), f32, [7, 8, 31, 511, 512, 700, 1000, 1023], None, 2e-5),
        ("page64_f32", dict(S=8, hkv=12, g=1, dh=64, page=64, M=16), f32, [63, 64, 31, 511, 512, 700, 1000, 1023], None, 2e-5),
        ("gpt2_bf16", dict(S=8, hkv=12, g=1, dh=64, page=16, M=64), bf16, gpt2_pos, None, 2e-2),
    ]
    checks, worst = [], {"decode": 0.0, "chunk": 0.0}
    for name, shp, dtype, pos, window, tol in dec_cases:
        q, kp, vp, table, pos_t = _paged_inputs(gen, shp["S"], shp["hkv"], shp["g"], shp["dh"],
                                                shp["page"], shp["M"], dtype, pos)
        o, lse = paged_flash_decode_lse(q, kp, vp, table, pos_t, shp["page"], window)
        torch.cuda.synchronize()
        wo, wl = paged_decode_reference_lse(q, kp, vp, table, pos_t, shp["page"], window)
        errs = [_allclose_err(o, wo, tol), _allclose_err(lse, wl, tol)]
        err = max(e for e, _ in errs)
        require(all(ok for _, ok in errs) and bool(torch.isfinite(o).all()),
                f"paged decode {name}: max abs err {err} beyond atol = rtol = {tol}")
        if dtype == f32:
            worst["decode"] = max(worst["decode"], err)
        checks.append({"kernel": "decode", "case": name, "shape": shp, "dtype": str(dtype),
                       "pos": pos, "window": window, "max_abs_err": err, "atol": tol,
                       "rtol": tol})
    chunk_cases = [
        ("prefill256_pos0_f32", dict(S=1, hkv=12, g=1, dh=64, page=16, M=64, C=256), f32, [0], None, 2e-5),
        ("prefill256_pos128_f32", dict(S=1, hkv=12, g=1, dh=64, page=16, M=64, C=256), f32, [128], None, 2e-5),
        ("c4_rows_f32", dict(S=8, hkv=12, g=1, dh=64, page=16, M=64, C=4), f32, [0, 15, 16, 29, 511, 700, 1000, 1020], None, 2e-5),
        ("gqa_dh128_c4_f32", dict(S=4, hkv=2, g=4, dh=128, page=16, M=64, C=4), f32, [31, 512, 700, 1020], None, 2e-5),
        ("window100_c256_f32", dict(S=2, hkv=12, g=1, dh=64, page=16, M=64, C=256), f32, [0, 300], 100, 2e-5),
        ("page8_c256_f32", dict(S=2, hkv=12, g=1, dh=64, page=8, M=128, C=256), f32, [0, 128], None, 2e-5),
        ("page64_c256_f32", dict(S=2, hkv=12, g=1, dh=64, page=64, M=16, C=256), f32, [0, 128], None, 2e-5),
        ("prefill256_bf16", dict(S=1, hkv=12, g=1, dh=64, page=16, M=64, C=256), bf16, [128], None, 2e-5),
        ("mixtral_insert_f32", dict(S=1, hkv=8, g=4, dh=128, page=16, M=128, C=256), f32, [0], None, 2e-5),
    ]
    for name, shp, dtype, pos0, window, tol in chunk_cases:
        q, kp, vp, table, pos_t = _paged_inputs(gen, shp["S"], shp["hkv"], shp["g"], shp["dh"],
                                                shp["page"], shp["M"], dtype, pos0, shp["C"])
        got = paged_flash_chunk(q, kp, vp, table, pos_t, shp["page"], window)
        torch.cuda.synchronize()
        want = paged_chunk_reference(q, kp, vp, table, pos_t, shp["page"], window)
        err, ok = _allclose_err(got, want, tol)
        require(ok and bool(torch.isfinite(got).all()),
                f"paged chunk {name}: max abs err {err} beyond atol = rtol = {tol}")
        require(torch.equal(paged_flash_chunk(q, kp, vp, table, pos_t, shp["page"], window),
                            got), f"paged chunk {name}: two launches differ")
        if dtype == f32:
            worst["chunk"] = max(worst["chunk"], err)
        checks.append({"kernel": "chunk", "case": name, "shape": shp, "dtype": str(dtype),
                       "pos0": pos0, "window": window, "max_abs_err": err, "atol": tol,
                       "rtol": tol})
        del q, kp, vp, table, got, want

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    # decode at the serving shape, at three position sets: chip_smoke's
    # gpt2_pos, the serve mix's positions (prompts of 32-256 tokens plus up
    # to 64 new) and a full cache; 8 pools of 50 MB so the reads miss the L2
    S, hkv, g, dh, page, M = 8, 12, 1, 64, 16, 64
    T = M * page
    slots = torch.arange(T, device="cuda")

    def time_decode(pos):
        sets = [_paged_inputs(gen, S, hkv, g, dh, page, M, f32, pos) for _ in range(8)]
        q, kp, vp, t, p = sets[0]
        o, lse = paged_flash_decode_lse(q, kp, vp, t, p, page)
        wo, wl = paged_decode_reference_lse(q, kp, vp, t, p, page)
        errs = [_allclose_err(o, wo, 2e-5), _allclose_err(lse, wl, 2e-5)]
        require(all(ok for _, ok in errs), f"paged decode at {pos}: beyond 2e-5")
        require(all(torch.equal(a, b) for a, b in
                    zip(paged_flash_decode_lse(q, kp, vp, t, p, page), (o, lse))),
                f"paged decode at {pos}: two launches differ")
        ms = device_ms(lambda q, kp, vp, t, p: paged_flash_decode_lse(q, kp, vp, t, p, page),
                       sets)
        plain_ms = device_ms(lambda q, kp, vp, t, p: paged_decode_reference_lse(
            q, kp, vp, t, p, page), sets)
        lib_sets = []
        for q, kp, vp, t, p in sets:
            kd, vd = _dense_view(kp, vp, t, page)
            lib_sets.append((q, kd, vd, (slots[None, :] <= p[:, None].long())[:, None, None, :]))
        lib_ms = device_ms(lambda q, k, v, m: sdpa(q, k, v, attn_mask=m), lib_sets)
        del sets, lib_sets
        vis = sum(_visible(pos, T))
        live_pages = sum(p // page + 1 for p in pos)
        n_bytes = (vis * hkv * dh * 2 * 4 + (2 * S * hkv * g * dh + S * hkv * g + S) * 4
                   + live_pages * 4)
        bms, by = bound_ms(n_bytes, vis * hkv * g * dh * 4)
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
                "bound_by": by, "pos": pos,
                "max_abs_err": max(e for e, _ in errs)}

    timed = {"gpt2_pos": time_decode(gpt2_pos), "serve_pos": time_decode(SERVE_POS),
             "full_cache": time_decode([T - 1] * S)}
    at = timed["gpt2_pos"]
    rows.append({"name": "paged_flash_decode_lse", "route": "cuda",
                 "source": "elephas_tpu_torch/ops/csrc/paged_attention.cu",
                 "replaces": "elephas_tpu/ops/paged_attention.py:178",
                 "max_abs_err": worst["decode"], "ms": at["ms"],
                 "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
                 "bound_by": at["bound_by"], "library_ms": at["library_ms"],
                 "library": "F.scaled_dot_product_attention over the equivalent dense "
                            "cache with an explicit mask (no PyTorch call reads a block table)",
                 "timed_shape": {"S": S, "Hkv": hkv, "G": g, "Dh": dh, "page": page, "M": M,
                                 "pos": gpt2_pos, "kv_dtype": "float32"},
                 "by_positions": timed})
    # chunk at the prefill insert shapes: one slot, a 256-token bucket at 0,
    # GPT-2's (the row's figures) and Mixtral's (Hkv 8, G 4, Dh 128)
    C = 256

    def time_chunk(hkv, g, dh, M):
        T = M * page
        sets = [_paged_inputs(gen, 1, hkv, g, dh, page, M, f32, [0], C) for _ in range(8)]
        ms = device_ms(lambda q, kp, vp, t, p: paged_flash_chunk(q, kp, vp, t, p, page), sets)
        plain_ms = device_ms(lambda q, kp, vp, t, p: paged_chunk_reference(q, kp, vp, t, p, page),
                             sets)
        rows_pos = torch.arange(C, device="cuda")
        mask = (torch.arange(T, device="cuda")[None, :] <= rows_pos[:, None])[None, None]
        lib_sets = []
        for q, kp, vp, t, p in sets:   # query head h * G + g reads KV head h
            kd, vd = (x.repeat_interleave(g, 1) for x in _dense_view(kp, vp, t, page))
            lib_sets.append((q[0].reshape(1, hkv * g, C, dh), kd, vd))
        lib_ms = device_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask), lib_sets)
        del sets, lib_sets
        pairs = hkv * g * C * (C + 1) // 2
        n_bytes = (C * hkv * dh * 2 * 4 + 2 * hkv * g * C * dh * 4 + (C // page) * 4 + 4)
        bms, by, simt_ms = k2_bound_ms(n_bytes, 4 * dh * pairs)
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bms,
                "bound_by": by, "bound_simt_ms": simt_ms,
                "shape": {"S": 1, "Hkv": hkv, "G": g, "C": C, "Dh": dh, "page": page, "M": M,
                          "pos0": [0], "kv_dtype": "float32"}}

    inserts = {"gpt2_insert": time_chunk(hkv, g, dh, M),
               "mixtral_insert": time_chunk(8, 4, 128, 128)}
    at = inserts["gpt2_insert"]
    rows.append({"name": "paged_flash_chunk", "route": "cuda",
                 "source": "elephas_tpu_torch/ops/csrc/paged_attention.cu",
                 "replaces": "elephas_tpu/ops/paged_attention.py:305",
                 "max_abs_err": worst["chunk"], "ms": at["ms"], "plain_ms": at["plain_ms"],
                 "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
                 "library_ms": at["library_ms"],
                 "library": "F.scaled_dot_product_attention over the equivalent dense "
                            "cache with an explicit mask (no PyTorch call reads a block table)",
                 "timed_shape": at["shape"], "by_shape": inserts})
    emit({"phase": "kernel", "kernel": "paged_attention", "checks": checks,
          "timing": [{k_: r[k_] for k_ in ("name", "ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")} for r in rows],
          "decode_by_positions": timed, "chunk_by_shape": inserts, "card": card})
    return rows


# -- phases 3 and 4 -------------------------------------------------------------


def serve(card):
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.ops.flash_decode import flash_decode_lse
    from elephas_tpu_torch.ops.layer_norm import fused_layer_norm
    from elephas_tpu_torch.serving import ServingEngine

    t0 = time.perf_counter()
    model = TransformerLM(**GPT2_SMALL, device="cuda")
    params = model.init(SEED)
    setup_s = time.perf_counter() - t0
    gen = np.random.default_rng(SEED + 2)
    V = GPT2_SMALL["vocab"]
    prompts = [gen.integers(0, V, size=int(n)).astype(np.int32)
               for n in gen.integers(32, 257, size=16)]
    max_new = 64

    # warm-up (cuBLAS handles, allocator), outside the counted run
    warm = ServingEngine(model, params, n_slots=8, device="cuda")
    for p in prompts[:2]:
        warm.submit(p[:32], 4)
    warm.drain()
    del warm
    torch.cuda.synchronize()

    eng = ServingEngine(model, params, n_slots=8, device="cuda")
    flash_decode_lse.launches = 0
    fused_layer_norm.launches = 0
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new) for p in prompts]
    fin = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4, k3 = flash_decode_lse.launches, fused_layer_norm.launches

    snap = eng.snapshot()
    steps = snap["engine"]["decode_steps"]
    prefills = snap["engine"]["prefills"]
    L = GPT2_SMALL["n_layers"]
    require(len(fin) == 16, f"{len(fin)} of 16 requests finished")
    for rid in ids:
        r = fin[rid]
        require(r.finish_reason == "length", f"{rid} finished by {r.finish_reason}")
        require(len(r.tokens) == max_new, f"{rid}: {len(r.tokens)} tokens")
        require(all(0 <= t < V for t in r.tokens), f"{rid}: token out of range")
    require(steps > 0 and k4 == L * steps,
            f"flash_decode launches {k4} != {L} x {steps} decode steps")
    require(k3 == (2 * L + 1) * (steps + prefills),
            f"layer_norm launches {k3} != {2 * L + 1} x ({steps} decode steps "
            f"+ {prefills} prefills)")
    stats = _serving_stats(snap, [fin[r] for r in ids], wall)
    emit({"phase": "serve", "model": "gpt2-small (random weights, seed 0)",
          "requests": 16, "new_tokens_each": max_new,
          "prompt_lens": [int(len(p)) for p in prompts],
          "decode_steps": steps, "prefills": prefills,
          "launches": {"flash_decode_lse": k4, "layer_norm_fwd": k3},
          "launches_per_decode_step": {"flash_decode_lse": k4 / steps},
          **stats, "weights_setup_s": setup_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "card": card})
    return params, prompts, [fin[r].tokens for r in ids], {
        "flash_decode_lse": k4, "layer_norm_fwd": k3}, stats


def _serving_stats(snap, finished, wall):
    """The end-to-end serving numbers of one drained run."""
    n_tok = sum(len(f.tokens) for f in finished)
    ttft = snap["requests"]["ttft_s"]
    itl = snap["fastpath"]["inter_token_latency_s"]
    return {"tokens": n_tok, "wall_s": wall, "tok_per_s": n_tok / wall,
            "ttft_p50_s": ttft["p50"], "ttft_p95_s": ttft["p95"],
            "decode_ms_per_step_p50": itl["p50"] * 1e3,
            "decode_ms_per_step_mean": itl["mean"] * 1e3,
            "batch_occupancy": snap["engine"]["batch_occupancy"]}


def cross_check(card, params, prompts, gpu_tokens):
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    model = TransformerLM(**GPT2_SMALL, device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    order = np.argsort([len(p) for p in prompts])[:2]   # the two shortest
    n_new = 8
    eng = ServingEngine(model, cpu_params, n_slots=2, device="cpu")
    ids = [eng.submit(prompts[i], n_new) for i in order]
    fin = eng.drain()
    rows = []
    for rid, i in zip(ids, order):
        cpu = fin[rid].tokens
        seq = np.concatenate([prompts[i], np.asarray(cpu[:-1], np.int32)])
        logits, _ = model.decode_chunk(
            cpu_params, torch.from_numpy(seq.astype(np.int64))[None], 0,
            model.init_cache(1, len(seq)))
        top = torch.topk(logits[0, len(prompts[i]) - 1:], 2, dim=-1).values
        gaps = (top[:, 0] - top[:, 1]).tolist()
        n = 0
        while n < n_new and gaps[n] > 1e-3:
            require(cpu[n] == gpu_tokens[i][n],
                    f"request {i}: position {n} gpu {gpu_tokens[i][n]} != "
                    f"cpu {cpu[n]} (gap {gaps[n]})")
            n += 1
        rows.append({"request": int(i), "prompt_len": int(len(prompts[i])),
                     "compared": n, "min_gap": min(gaps), "cpu": cpu,
                     "gpu": gpu_tokens[i][:n_new]})
    emit({"phase": "cross_check", "requests": rows, "card": card})


def profiled(run, n_steps: int, top_n: int = 12, ops=()):
    """``run()`` ``n_steps`` times under ``torch.profiler``: wall ms and
    device ms per step, the device's busy share of the window (the
    profiler's own host cost inflates the wall time), the kernels that
    took the most device time and, for each name in ``ops``, how often the
    host called that operator (``"aten::convolution_backward"``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    out = {"wall_ms_per_step": wall * 1e3 / n_steps,
           "device_ms_per_step": busy_us / 1e3 / n_steps,
           "device_busy_share": busy_us / 1e6 / wall if busy_us else None,
           "top_kernels": [{"name": e.key[:90], "count": e.count,
                            "us_per_step": e.self_device_time_total / n_steps}
                           for e in top]}
    if ops:
        events = prof.key_averages()
        out["op_counts"] = {op: sum(e.count for e in events if e.key == op) for op in ops}
    return out


def profile_decode(card, params, prompts):
    """Ten decode steps of a full 8-slot batch under ``torch.profiler``
    (the unprofiled step time is the serve phase's)."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    eng = ServingEngine(model, params, n_slots=8, device="cuda")
    for p in prompts[:8]:
        eng.submit(p, 32)
    while eng.kv.free_slots:
        eng.step()

    def run():
        require(eng.step() == "decode", "profile window left the decode loop")

    emit({"phase": "profile", "decode_steps": 10, **profiled(run, 10),
          "card": card})


# -- phases 6 to 8 -----------------------------------------------------------------


def _counters():
    """Every kernel wrapper of the port by its row name."""
    from elephas_tpu_torch.ops.flash_attention import (
        flash_attention_dkv, flash_attention_dq, flash_attention_fwd,
        flash_attention_rope_dkv, flash_attention_rope_dq, flash_attention_rope_fwd)
    from elephas_tpu_torch.ops.flash_decode import flash_decode_lse
    from elephas_tpu_torch.ops.fused_xent import fused_xent_bwd, fused_xent_fwd
    from elephas_tpu_torch.ops.grouped_matmul import gmm, gmm_t, tgmm
    from elephas_tpu_torch.ops.layer_norm import (fused_layer_norm,
                                                  fused_layer_norm_bwd)
    from elephas_tpu_torch.ops.paged_attention import (paged_flash_chunk,
                                                       paged_flash_decode_lse)

    return {"layer_norm_fwd": fused_layer_norm, "layer_norm_bwd": fused_layer_norm_bwd,
            "flash_decode_lse": flash_decode_lse,
            "flash_attention_fwd": flash_attention_fwd,
            "flash_attention_dq": flash_attention_dq,
            "flash_attention_dkv": flash_attention_dkv,
            "flash_attention_rope_fwd": flash_attention_rope_fwd,
            "flash_attention_rope_dq": flash_attention_rope_dq,
            "flash_attention_rope_dkv": flash_attention_rope_dkv,
            "paged_flash_decode_lse": paged_flash_decode_lse,
            "paged_flash_chunk": paged_flash_chunk,
            "gmm": gmm, "gmm_t": gmm_t, "tgmm": tgmm,
            "fused_xent_fwd": fused_xent_fwd, "fused_xent_bwd": fused_xent_bwd}


def _zero_counters():
    for fn in _counters().values():
        fn.launches = 0


def _read_counters():
    return {name: fn.launches for name, fn in _counters().items()}


def train(card, params):
    """GPT-2-small training through the port's step builder: counters set
    to 0 just before the timed steps and read just after."""
    from elephas_tpu_torch.models import (TransformerLM, adam_compact,
                                          build_lm_train_step, make_lm_batches)

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    B, T = 8, 1024
    rows = np.random.default_rng(SEED + 4).integers(0, GPT2_SMALL["vocab"],
                                                    size=(B, T + 1))
    batch = tuple(torch.from_numpy(a).cuda() for a in make_lm_batches(rows))
    step, opt_init = build_lm_train_step(model, None, adam_compact(1e-3),
                                         attn="flash")
    state = opt_init(params)
    p = params
    losses = []
    for _ in range(2):                                  # warm-up
        p, state, loss = step(p, state, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps = 5
    _zero_counters()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        p, state, loss = step(p, state, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    L = GPT2_SMALL["n_layers"]
    require(all(np.isfinite(losses)), f"train: non-finite loss in {losses}")
    require(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    want = {"flash_attention_fwd": L, "flash_attention_dq": L,
            "flash_attention_dkv": L, "layer_norm_fwd": 2 * L + 1,
            "layer_norm_bwd": 2 * L + 1, "flash_decode_lse": 0,
            "flash_attention_rope_fwd": 0, "flash_attention_rope_dq": 0,
            "flash_attention_rope_dkv": 0}
    for name, per_step in want.items():
        require(counts[name] == per_step * n_steps,
                f"train: {name} launched {counts[name]} times in {n_steps} "
                f"steps, want {per_step} per step")

    # one more step under the profiler: where the device time goes
    prof = profiled(lambda: step(p, state, *batch), 1, top_n=16)

    # the streamed head against the dense head, one step from the same state
    step_vb, _ = build_lm_train_step(model, None, adam_compact(1e-3),
                                     attn="flash", vocab_block=8192)
    loss_vb = float(step_vb(p, state, *batch)[2])
    loss_dense = float(step(p, state, *batch)[2])
    rel = abs(loss_vb - loss_dense) / abs(loss_dense)
    require(rel <= 1e-5, f"train: vocab_block loss {loss_vb} vs dense "
                         f"{loss_dense} (relative {rel} > 1e-5)")
    emit({"phase": "train", "model": "gpt2-small (random weights, seed 0)",
          "dtype": "float32", "optimizer": "adam_compact(1e-3)", "attn": "flash",
          "batch": B, "seq_len": T, "warmup_steps": 2, "timed_steps": n_steps,
          "ms_per_step": wall * 1e3 / n_steps,
          "tokens_per_s": n_steps * B * T / wall,
          "peak_mem_gb": peak / 1e9, "losses": losses,
          "launches": counts,
          "launches_per_step": {k: v / n_steps for k, v in counts.items()},
          "vocab_block_8192": {"loss": loss_vb, "dense_loss": loss_dense,
                               "relative_diff": rel, "rtol": 1e-5},
          "profiled_step": prof, "card": card})
    return counts


def train_cross_check(card, params):
    """One step's loss and gradients at B=1, T=128: the card's kernels
    against the CPU's plain versions. Loss rtol 1e-4; every gradient
    within 1e-3 of its parameter's largest gradient entry (float32 sums in
    another order through 12 layers). That scale is floored at 1e-4 of the
    largest entry over all parameters: the key bias ``bk`` has an exact
    gradient of zero (softmax ignores a shift of all of a query's scores),
    so its entries are rounding noise on both devices."""
    from elephas_tpu_torch.models import (TransformerLM, adam_compact,
                                          build_lm_train_step, make_lm_batches)

    rows = np.random.default_rng(SEED + 6).integers(0, GPT2_SMALL["vocab"],
                                                    size=(1, 129))
    batch = make_lm_batches(rows)
    out = {}
    for dev, p in (("cuda", params), ("cpu", {k: v.cpu() for k, v in params.items()})):
        model = TransformerLM(**GPT2_SMALL, device=dev)
        step, _ = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")
        loss, grads = step.grad(p, *batch)
        out[dev] = (float(loss), {k: g.cpu().double() for k, g in grads.items()})
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    require(loss_rel <= 1e-4, f"train_cross_check: loss {lg} vs cpu {lc}")
    floor = 1e-4 * max(float(g.abs().max()) for g in gc.values())
    grad_rel, grad_maxabs = {}, {}
    for k in gc:
        grad_maxabs[k] = float(gc[k].abs().max())
        grad_rel[k] = float((gg[k] - gc[k]).abs().max()) / max(grad_maxabs[k], floor)
    worst = max(grad_rel, key=grad_rel.get)
    require(grad_rel[worst] <= 1e-3,
            f"train_cross_check: gradient of {worst} off by {grad_rel[worst]} "
            f"of its scale")
    emit({"phase": "train_cross_check", "batch": 1, "seq_len": 128,
          "loss_gpu": lg, "loss_cpu": lc, "loss_rel_diff": loss_rel,
          "loss_rtol": 1e-4, "grad_err_rel_to_scale": grad_rel,
          "grad_maxabs_cpu": grad_maxabs, "scale_floor": floor,
          "grad_tol": 1e-3, "card": card})


def generate_phase(card, params):
    """Greedy ``generate`` on the card: its launch counts, then its tokens
    against the serving engine's on the same prompts."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    V, L = GPT2_SMALL["vocab"], GPT2_SMALL["n_layers"]
    rows, t0_len, n_new = 4, 128, 32
    prompts = np.random.default_rng(SEED + 7).integers(0, V, size=(rows, t0_len))
    prompt = torch.from_numpy(prompts).cuda()
    model.generate(params, prompt[:, :16], 2)           # warm-up
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    out = model.generate(params, prompt, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    decode_steps = n_new - 1
    require(tuple(out.shape) == (rows, t0_len + n_new), f"generate: shape {tuple(out.shape)}")
    require(bool(((out >= 0) & (out < V)).all()), "generate: token out of range")
    require(counts["flash_attention_fwd"] == L,
            f"generate: {counts['flash_attention_fwd']} flash-attention launches, "
            f"want {L} (one prefill)")
    require(counts["flash_decode_lse"] == L * decode_steps,
            f"generate: {counts['flash_decode_lse']} flash-decode launches, want "
            f"{L} x {decode_steps} decode steps")
    require(counts["layer_norm_fwd"] == (2 * L + 1) * (1 + decode_steps),
            f"generate: {counts['layer_norm_fwd']} layer-norm launches")
    require(counts["layer_norm_bwd"] + counts["flash_attention_dq"]
            + counts["flash_attention_dkv"] == 0, "generate: a backward kernel ran")

    eng = ServingEngine(model, params, n_slots=rows, device="cuda")
    ids = [eng.submit(p.astype(np.int32), n_new) for p in prompts]
    fin = eng.drain()
    gen = out[:, t0_len:].cpu()
    with torch.no_grad():
        pos = torch.arange(t0_len + n_new - 1, device=out.device).expand(rows, -1)
        logits = model.apply(params, out[:, :-1], pos, attn="flash")
        top = torch.topk(logits[:, t0_len - 1:], 2, dim=-1).values.cpu()
    gaps = (top[..., 0] - top[..., 1])
    compared = []
    for r, rid in enumerate(ids):
        eng_tokens = fin[rid].tokens
        n = 0
        while n < n_new and float(gaps[r, n]) > 1e-3:
            require(int(gen[r, n]) == eng_tokens[n],
                    f"generate: row {r} position {n}: generate {int(gen[r, n])} "
                    f"!= engine {eng_tokens[n]} (gap {float(gaps[r, n])})")
            n += 1
        compared.append(n)
    emit({"phase": "generate", "rows": rows, "prompt_len": t0_len, "n_new": n_new,
          "wall_s": wall, "tok_per_s": rows * n_new / wall,
          "launches": counts, "tokens_compared_with_engine": compared,
          "min_gap": float(gaps.min()), "card": card})
    return counts

# -- phases 10 to 13: paged serving ------------------------------------------------


def _top2_gaps(model, params, prompt, tokens):
    """Top-1 minus top-2 logit at each generated position, from one
    teacher-forced pass on the params' device."""
    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)]).astype(np.int64)
    with torch.no_grad():
        logits, _ = model.decode_chunk(
            params, torch.from_numpy(seq)[None].to(params["tok"].device), 0,
            model.init_cache(1, len(seq)))
        top = torch.topk(logits[0, len(prompt) - 1:], 2, dim=-1).values.cpu()
    return (top[:, 0] - top[:, 1]).tolist()


def _agree(what, model, params, prompts, got, want):
    """Tokens of two runs agree up to each request's first near tie (top-2
    gap 1e-3 or less, where either choice is right); returns how many
    positions each request compared."""
    compared = []
    for i, (prompt, a, b) in enumerate(zip(prompts, got, want)):
        gaps = _top2_gaps(model, params, prompt, b)
        n = 0
        while n < len(b) and gaps[n] > 1e-3:
            require(a[n] == b[n], f"{what}: request {i} position {n}: {a[n]} != {b[n]} "
                                  f"(gap {gaps[n]})")
            n += 1
        compared.append(n)
    return compared


def _drain(eng, prompts, max_new):
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new) for p in prompts]
    fin = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(len(fin) == len(ids), f"{len(fin)} of {len(ids)} requests finished")
    for rid in ids:
        require(fin[rid].finish_reason == "length" and len(fin[rid].tokens) == max_new,
                f"{rid}: {fin[rid].finish_reason}, {len(fin[rid].tokens)} tokens")
    return [fin[r] for r in ids], wall


def serve_paged(card, params, prompts, dense_tokens, dense_stats):
    """The ``serve`` mix through the paged engine: launch counts per decode
    step and per insert, tokens against the dense engine's, ``kv.check``."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    L = GPT2_SMALL["n_layers"]
    warm = ServingEngine(model, params, n_slots=8, paged=True, page_size=16, device="cuda")
    _drain(warm, [p[:32] for p in prompts[:2]], 4)
    del warm
    eng = ServingEngine(model, params, n_slots=8, paged=True, page_size=16, device="cuda")
    _zero_counters()
    fin, wall = _drain(eng, prompts, 64)
    counts = _read_counters()
    snap = eng.snapshot()
    steps, inserts = snap["engine"]["decode_steps"], snap["engine"]["prefills"]
    eng.kv.check()
    require(steps > 0 and counts["paged_flash_decode_lse"] == L * steps,
            f"serve_paged: paged decode launched {counts['paged_flash_decode_lse']} "
            f"times, want {L} x {steps} decode steps")
    require(counts["paged_flash_chunk"] == L * inserts,
            f"serve_paged: paged chunk launched {counts['paged_flash_chunk']} times, "
            f"want {L} x {inserts} inserts")
    require(counts["flash_decode_lse"] == 0, "serve_paged: the dense decode kernel ran")
    require(counts["layer_norm_fwd"] == (2 * L + 1) * (steps + inserts),
            f"serve_paged: layer_norm launches {counts['layer_norm_fwd']}")
    tokens = [f.tokens for f in fin]
    compared = _agree("serve_paged vs serve", model, params, prompts, tokens, dense_tokens)
    stats = _serving_stats(snap, fin, wall)
    # the host's share of a step moves from run to run: dense and paged
    # again, three of each in turns, for a like-for-like step time
    turns = []
    for paged in (False, True, True, False, False, True):
        e = ServingEngine(model, params, n_slots=8, paged=paged, page_size=16,
                          device="cuda")
        f, w = _drain(e, prompts, 64)
        st = _serving_stats(e.snapshot(), f, w)
        turns.append({"engine": "paged" if paged else "dense",
                      **{k: st[k] for k in ("decode_ms_per_step_p50", "tok_per_s",
                                            "ttft_p50_s")}})
    emit({"phase": "serve_paged", "page_size": 16, "decode_steps": steps,
          "inserts": inserts, "launches": counts,
          "launches_per_decode_step": {"paged_flash_decode_lse":
                                       counts["paged_flash_decode_lse"] / steps},
          "launches_per_insert": {"paged_flash_chunk": counts["paged_flash_chunk"] / inserts},
          **stats, "dense_same_call": dense_stats, "in_turns": turns,
          "in_turns_mean_ms_per_step": {
              e_: float(np.mean([t["decode_ms_per_step_p50"] for t in turns
                                 if t["engine"] == e_])) for e_ in ("dense", "paged")},
          "tokens_compared_with_dense": compared, "memory": snap["memory"],
          "card": card})
    return tokens, counts, stats


def profile_paged(card, params, prompts):
    """Ten paged decode steps of a full 8-slot batch under ``torch.profiler``."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    eng = ServingEngine(model, params, n_slots=8, paged=True, page_size=16, device="cuda")
    for p in prompts[:8]:
        eng.submit(p, 32)
    while eng.kv.free_slots:
        eng.step()

    def run():
        require(eng.step() == "decode", "profile_paged window left the decode loop")

    emit({"phase": "profile_paged", "decode_steps": 10, **profiled(run, 10),
          "card": card})


def prefix(card, params):
    """A shared 192-token prefix: pages adopted against the CPU paged
    engine's count on the same mix, tokens with and without the cache."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    gen = np.random.default_rng(SEED + 9)
    V = GPT2_SMALL["vocab"]
    shared = gen.integers(0, V, size=192).astype(np.int32)
    prompts = [np.concatenate([shared, gen.integers(0, V, size=int(n)).astype(np.int32)])
               for n in gen.integers(16, 65, size=16)]
    model = TransformerLM(**GPT2_SMALL, device="cuda")
    runs = {}
    for cache_on in (True, False):
        eng = ServingEngine(model, params, n_slots=8, paged=True, page_size=16,
                            prefix_cache=cache_on, device="cuda")
        fin, wall = _drain(eng, prompts, 32)
        eng.kv.check()
        runs[cache_on] = (fin, wall, eng.snapshot())
    # the page bookkeeping reads no weights: the CPU engine runs the same
    # mix at GPT-2 width with the depth cut to 2 layers
    cpu_model = TransformerLM(**dict(GPT2_SMALL, n_layers=2), device="cpu")
    shapes = cpu_model.param_shapes()
    cpu_params = {k: v[:shapes[k][0]].cpu() for k, v in params.items()}
    cpu = ServingEngine(cpu_model, cpu_params, n_slots=8, paged=True, page_size=16,
                        device="cpu")
    for p in prompts:
        cpu.submit(p, 32)
    cpu.drain()
    cpu_hits = cpu.kv.memory_stats()["prefix"]["hits_pages"]
    on, off = runs[True][2]["memory"]["prefix"], runs[False][2]["memory"]["prefix"]
    require(on["hits_pages"] == cpu_hits,
            f"prefix: {on['hits_pages']} pages adopted on the card, {cpu_hits} on the CPU")
    require(on["hits_pages"] > 0 and off["hits_pages"] == 0, f"prefix: hits {on} / {off}")
    compared = _agree("prefix on vs off", model, params, prompts,
                      [f.tokens for f in runs[True][0]], [f.tokens for f in runs[False][0]])
    emit({"phase": "prefix", "shared_prefix": 192, "requests": 16, "new_tokens_each": 32,
          "suffix_lens": [int(len(p)) - 192 for p in prompts],
          "hits_pages": on["hits_pages"], "lookups_pages": on["lookups_pages"],
          "cpu_hits_pages": cpu_hits,
          "cache_on": _serving_stats(runs[True][2], runs[True][0], runs[True][1]),
          "cache_off": _serving_stats(runs[False][2], runs[False][0], runs[False][1]),
          "tokens_compared": compared, "card": card})


def preempt(card, params):
    """8 requests of 256 + 64 tokens (20 pages of 16 each, 160 in all) in a
    pool of 144 usable pages: all are admitted (17 pages each), growth
    preempts the newest, and every stream matches an unpressured run."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    gen = np.random.default_rng(SEED + 10)
    prompts = [gen.integers(0, GPT2_SMALL["vocab"], size=256).astype(np.int32)
               for _ in range(8)]
    model = TransformerLM(**GPT2_SMALL, device="cuda")
    runs = {}
    for pool in (None, 145):
        eng = ServingEngine(model, params, n_slots=8, paged=True, page_size=16,
                            pages_per_partition=pool, prefix_cache=False, device="cuda")
        fin, wall = _drain(eng, prompts, 64)
        eng.kv.check()
        runs[pool] = (fin, wall, eng.kv.memory_stats(), eng.snapshot())
    mem = runs[145][2]
    require(mem["preemptions"] > 0, "preempt: no preemption under pressure")
    require(mem["pages_used"] == 0, f"preempt: {mem['pages_used']} pages still held")
    compared = _agree("preempt vs unpressured", model, params, prompts,
                      [f.tokens for f in runs[145][0]], [f.tokens for f in runs[None][0]])
    emit({"phase": "preempt", "requests": 8, "prompt_len": 256, "new_tokens_each": 64,
          "pages_per_partition": 145, "preemptions": mem["preemptions"],
          "pages_used_after": mem["pages_used"],
          "pressured": _serving_stats(runs[145][3], runs[145][0], runs[145][1]),
          "unpressured": _serving_stats(runs[None][3], runs[None][0], runs[None][1]),
          "tokens_compared": compared, "card": card})


def paged_cross_check(card, params, prompts, gpu_tokens):
    """Two requests of the serve mix, 8 new tokens, on a ``device="cpu"``
    paged engine (the plain paged path) against the card's paged tokens."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    model = TransformerLM(**GPT2_SMALL, device="cpu")
    cpu_params = {k: v.cpu() for k, v in params.items()}
    order = np.argsort([len(p) for p in prompts])[:2]
    eng = ServingEngine(model, cpu_params, n_slots=2, paged=True, page_size=16,
                        device="cpu")
    ids = [eng.submit(prompts[i], 8) for i in order]
    fin = eng.drain()
    eng.kv.check()
    cpu = [fin[r].tokens for r in ids]
    sel = [prompts[i] for i in order]
    compared = _agree("paged_cross_check", model, cpu_params, sel,
                      [gpu_tokens[i][:8] for i in order], cpu)
    emit({"phase": "paged_cross_check", "requests": [int(i) for i in order],
          "compared": compared, "cpu": cpu, "gpu": [gpu_tokens[i][:8] for i in order],
          "card": card})


# -- phases 13a to 13f: speculative decoding ------------------------------------

# DistilGPT2's published widths (Hugging Face ``distilgpt2`` config.json: 6
# layers, d 768, 12 heads, vocab 50257, n_positions 1024, gelu, tied
# embeddings): GPT-2-small cut to 6 layers, the cheap drafter
DISTILGPT2 = dict(GPT2_SMALL, n_layers=6)
SPEC_K = 4
# the paged verify's per-slot positions: the serve mix's range, unaligned
SPEC_POS0 = [33, 62, 100, 143, 207, 254, 287, 318]


def check_spec_kernels(card):
    """K5-chunk and K3-fwd at the speculative verify's shapes: K5-chunk over
    GPT-2's 8 slots with C = 2 and 4 rows at the unaligned positions
    ``SPEC_POS0`` (some rows cross a page edge), K3-fwd over the chunk's
    ``[8·C, 768]`` rows; each against its plain version (2e-5 for K5-chunk,
    as the insert cases; 1e-5 for K3-fwd, as its other cases), twice for the
    same bits, timed beside the plain version, the library call (SDPA over
    the dense view with an explicit mask; ``F.layer_norm``) and the bound."""
    from elephas_tpu_torch.ops.layer_norm import fused_layer_norm, layer_norm_reference
    from elephas_tpu_torch.ops.paged_attention import paged_chunk_reference, paged_flash_chunk

    gen = np.random.default_rng(SEED + 12)
    S, hkv, g, dh, page, M = 8, 12, 1, 64, 16, 64
    T = M * page
    sdpa = torch.nn.functional.scaled_dot_product_attention
    chunk, ln = {}, {}
    for C in (2, 4):
        sets = [_paged_inputs(gen, S, hkv, g, dh, page, M, torch.float32, SPEC_POS0, C)
                for _ in range(8)]
        q, kp, vp, t, p = sets[0]
        got = paged_flash_chunk(q, kp, vp, t, p, page)
        torch.cuda.synchronize()
        err, ok = _allclose_err(got, paged_chunk_reference(q, kp, vp, t, p, page), 2e-5)
        require(ok and bool(torch.isfinite(got).all()),
                f"paged chunk at the verify shape C {C}: max abs err {err} beyond 2e-5")
        require(torch.equal(paged_flash_chunk(q, kp, vp, t, p, page), got),
                f"paged chunk at the verify shape C {C}: two launches differ")
        ms = device_ms(lambda q, kp, vp, t, p: paged_flash_chunk(q, kp, vp, t, p, page), sets)
        plain_ms = device_ms(lambda q, kp, vp, t, p: paged_chunk_reference(q, kp, vp, t, p, page),
                             sets)
        lib_sets = []
        for q, kp, vp, t, p in sets:
            kd, vd = _dense_view(kp, vp, t, page)
            rows = p.long()[:, None] + torch.arange(C, device="cuda")
            mask = torch.arange(T, device="cuda")[None, None, :] <= rows[:, :, None]
            lib_sets.append((q.reshape(S, hkv * g, C, dh), kd, vd, mask[:, None]))
        lib_ms = device_ms(lambda q, k, v, m: sdpa(q, k, v, attn_mask=m), lib_sets)
        del sets, lib_sets
        pairs = sum(x + c + 1 for x in SPEC_POS0 for c in range(C)) * hkv * g
        keys = sum(x + C for x in SPEC_POS0)
        pages = sum((x + C - 1) // page + 1 for x in SPEC_POS0)
        n_bytes = keys * hkv * dh * 2 * 4 + 2 * S * hkv * g * C * dh * 4 + pages * 4 + S * 4
        bms, by, simt_ms = k2_bound_ms(n_bytes, 4 * dh * pairs)
        chunk[f"C{C}"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": bms, "bound_by": by, "bound_simt_ms": simt_ms,
                          "max_abs_err": err, "atol": 2e-5, "same_bits": True,
                          "rows_crossing_a_page": sum(x // page != (x + C - 1) // page
                                                      for x in SPEC_POS0),
                          "shape": {"S": S, "Hkv": hkv, "G": g, "C": C, "Dh": dh,
                                    "page": page, "M": M, "pos0": SPEC_POS0}}
        n, d = S * C, 768
        sets = [tuple(torch.from_numpy(a).cuda() for a in (
            gen.normal(size=(n, d)).astype(np.float32),
            (1 + 0.1 * gen.normal(size=d)).astype(np.float32),
            gen.normal(size=d).astype(np.float32))) for _ in range(4)]
        x, s, b = sets[0]
        got = fused_layer_norm(x, s, b)
        torch.cuda.synchronize()
        err = float((got - layer_norm_reference(x, s, b)).abs().max())
        require(err <= 1e-5, f"layer_norm [{n}, {d}]: max abs err {err} > 1e-5")
        require(torch.equal(fused_layer_norm(x, s, b), got), f"layer_norm [{n}, {d}]: two launches differ")
        ln[f"C{C}"] = {"shape": [n, d], "max_abs_err": err, "atol": 1e-5, "same_bits": True,
                       "ms": device_ms(fused_layer_norm, sets),
                       "plain_ms": device_ms(lambda x, s, b: layer_norm_reference(x, s, b), sets),
                       "library_ms": device_ms(lambda x, s, b: torch.nn.functional.layer_norm(
                           x, (d,), s, b, 1e-5), sets),
                       **dict(zip(("bound_ms", "bound_by"),
                                  bound_ms((2 * n * d + 2 * d) * 4, 8 * n * d)))}
    emit({"phase": "kernel", "kernel": "spec_verify_shapes", "paged_flash_chunk": chunk,
          "layer_norm_fwd": ln, "card": card})
    return {"paged_flash_chunk": chunk, "layer_norm_fwd": ln}


def _noisy_gaps(model, params, prompt, tokens, seed, temperature):
    """The margin of a sampled selection at each generated position: top-1
    minus top-2 of ``logits / temperature`` plus the engine's ``(seed,
    position)`` Gumbel noise, from one teacher-forced pass."""
    from elephas_tpu_torch.models.transformer import _gumbel

    seq = np.concatenate([prompt, np.asarray(tokens[:-1], np.int32)]).astype(np.int64)
    dev = params["tok"].device
    with torch.no_grad():
        logits, _ = model.decode_chunk(params, torch.from_numpy(seq)[None].to(dev), 0,
                                       model.init_cache(1, len(seq)))
        logits = logits[0, len(prompt) - 1:].to(torch.float32)
        n = logits.shape[0]
        out_pos = torch.arange(len(prompt), len(prompt) + n, device=dev)
        scores = logits / temperature + _gumbel(
            torch.full((n,), seed, dtype=torch.int64, device=dev), out_pos, logits.shape[-1])
        top = torch.topk(scores, 2, dim=-1).values.cpu()
    return (top[:, 0] - top[:, 1]).tolist()


def _spec_run(model, params, prompts, max_new, drafter=None, paged=False,
              temperature=0.0, speculate_k=SPEC_K, adapter_ids=None, max_len=None):
    """One counted speculative engine run: counters set to 0 just before and
    read just after; per verify round the metrics' ``block_s`` and
    ``host_s`` and the drafting time, caught as the engine reports them.
    ``adapter_ids`` gives each request's adapter (a multi-tenant model)."""
    from elephas_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, params, n_slots=8, paged=paged, page_size=16,
                        speculate_k=speculate_k, drafter=drafter, max_len=max_len,
                        device="cuda")
    rounds, drafting = [], []
    observe, draft = eng.metrics.observe_spec_round, eng._draft_tokens

    def observe_round(n_active, n_drafted, n_accepted, n_emitted, block_s=None, host_s=None):
        rounds.append((block_s, host_s))
        observe(n_active, n_drafted, n_accepted, n_emitted, block_s=block_s, host_s=host_s)

    def timed_draft(W):
        t0 = time.perf_counter()
        out = draft(W)
        drafting.append(time.perf_counter() - t0)
        return out
    eng.metrics.observe_spec_round, eng._draft_tokens = observe_round, timed_draft
    _zero_counters()
    t0 = time.perf_counter()
    aids = [0] * len(prompts) if adapter_ids is None else adapter_ids
    ids = [eng.submit(p, max_new, temperature=temperature, seed=i, adapter_id=a)
           for i, (p, a) in enumerate(zip(prompts, aids))]
    fin = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    require(len(fin) == len(ids), f"{len(fin)} of {len(ids)} requests finished")
    for rid in ids:
        require(fin[rid].finish_reason == "length" and len(fin[rid].tokens) == max_new,
                f"{rid}: {fin[rid].finish_reason}, {len(fin[rid].tokens)} tokens")
    snap = eng.snapshot()
    fp = snap["fastpath"]
    block = np.array([r[0] for r in rounds])
    host = np.array([r[1] for r in rounds])
    n_rounds = fp.get("spec_rounds", 0)      # the section is absent at speculate_k 1
    stats = {**_serving_stats(snap, [fin[r] for r in ids], wall),
             "spec_rounds": n_rounds,
             "sequential_steps": snap["engine"]["decode_steps"] - n_rounds,
             "acceptance_rate": fp.get("spec_accepted", 0) / max(fp.get("spec_drafted", 0), 1),
             "emitted_per_row_per_round": fp.get("spec_emitted", 0) / max(fp.get("spec_rows", 0), 1),
             "round_ms_p50": float(np.median(block + host)) * 1e3 if rounds else None,
             "round_host_ms_p50": float(np.median(host)) * 1e3 if rounds else None,
             "round_host_share": float(host.sum() / (block + host).sum()) if rounds else None,
             "drafting_ms_p50": float(np.median(drafting)) * 1e3 if drafting else None,
             "drafting_share": (float(np.sum(drafting) / (block + host).sum())
                                if rounds else None)}
    if paged:
        eng.kv.check()
    return eng, [fin[r].tokens for r in ids], counts, stats


def _want_spec_launches(what, eng, counts, paged):
    """Exact counts from the snapshot and the drafter's own steps: K3-fwd
    2L+1 per verify round, sequential step and insert, 2L_d+1 per draft step
    and draft insert (none for an rmsnorm model); K4 L per sequential dense
    step and L_d per draft step; K5-chunk L per paged insert and verify
    round, K5-decode L per sequential paged step; nothing else."""
    from elephas_tpu_torch.serving import ModelDrafter

    snap = eng.snapshot()
    L = eng.model.n_layers
    rounds = snap["fastpath"]["spec_rounds"]
    steps = snap["engine"]["decode_steps"] - rounds
    inserts = snap["engine"]["prefills"]
    d = eng.drafter if isinstance(eng.drafter, ModelDrafter) else None
    Ld, d_steps, d_inserts = (d.model.n_layers, d.steps, d.prefills) if d else (0, 0, 0)
    ln, ln_d = (eng.model.norm == "layernorm"), (d is not None and d.model.norm == "layernorm")
    want = {"layer_norm_fwd": ln * (2 * L + 1) * (rounds + steps + inserts)
            + ln_d * (2 * Ld + 1) * (d_steps + d_inserts),
            "flash_decode_lse": (0 if paged else L * steps) + Ld * d_steps,
            "paged_flash_decode_lse": L * steps if paged else 0,
            "paged_flash_chunk": L * (inserts + rounds) if paged else 0}
    require(rounds > 0, f"{what}: no verify round ran")
    require(d is None or d_inserts == inserts, f"{what}: {d_inserts} draft inserts, "
                                               f"{inserts} inserts")
    for name, n in counts.items():
        require(n == want.get(name, 0), f"{what}: {name} launched {n} times, want "
                                        f"{want.get(name, 0)} ({rounds} verify rounds, "
                                        f"{steps} steps, {inserts} inserts, {d_steps} draft "
                                        f"steps, {d_inserts} draft inserts)")
    return {"verify_rounds": rounds, "sequential_steps": steps, "inserts": inserts,
            "draft_steps": d_steps, "draft_inserts": d_inserts}


def _distil_drafter():
    """A draft model at DistilGPT2's widths, random weights drawn on the card
    from its own seed."""
    from elephas_tpu_torch.models import TransformerLM

    model = TransformerLM(**DISTILGPT2, device="cuda")
    return model, draw_params(model, SEED + 11)


def _sum_counts(runs):
    return {k: sum(c[k] for c in runs) for k in runs[0]}


def serve_spec(card, params, prompts, dense_tokens, dense_stats):
    """The ``serve`` mix at ``speculate_k=4`` with the n-gram drafter, a
    self-draft and a drafter at DistilGPT2's widths: exact launch counts,
    tokens against ``serve``'s up to near ties, acceptance and time a round
    beside ``serve``'s step."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ModelDrafter

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    distil, distil_params = _distil_drafter()
    drafters = {"ngram": lambda: None, "self": lambda: ModelDrafter(model, params),
                "distilgpt2": lambda: ModelDrafter(distil, distil_params)}
    runs, all_counts = {}, []
    for name, make in drafters.items():
        _spec_run(model, params, [p[:32] for p in prompts[:2]], 8, make())   # warm-up
        eng, tokens, counts, stats = _spec_run(model, params, prompts, 64, make())
        launches = _want_spec_launches(f"serve_spec {name}", eng, counts, paged=False)
        compared = _agree(f"serve_spec {name} vs serve", model, params, prompts, tokens,
                          dense_tokens)
        runs[name] = {**stats, **launches, "launches": counts, "tokens_compared": compared}
        all_counts.append(counts)
    require(runs["self"]["acceptance_rate"] > 0.9,
            f"serve_spec: a self-draft accepted {runs['self']['acceptance_rate']}")
    emit({"phase": "serve_spec", "speculate_k": SPEC_K, "drafter_widths": {
              "distilgpt2": {k: DISTILGPT2[k] for k in ("n_layers", "d_model", "n_heads",
                                                        "vocab", "max_len")}},
          "runs": runs, "serve_same_call": dense_stats, "card": card})
    return _sum_counts(all_counts)


def serve_spec_sampled(card, params, prompts):
    """Eight of the mix's prompts at temperature 0.8: the speculative stream
    (n-gram drafter) against a ``speculate_k=1`` engine's in the same phase,
    compared up to each request's first position whose noisy margin (the
    scaled logits plus the engine's Gumbel noise) is 1e-3 or less."""
    from elephas_tpu_torch.models import TransformerLM

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    sel = prompts[:8]
    _, want, _, plain = _spec_run(model, params, sel, 64, temperature=0.8, speculate_k=1)
    _, got, _, stats = _spec_run(model, params, sel, 64, temperature=0.8)
    compared = []
    for i, (prompt, a, b) in enumerate(zip(sel, got, want)):
        gaps = _noisy_gaps(model, params, prompt, b, i, 0.8)
        n = 0
        while n < len(b) and gaps[n] > 1e-3:
            require(a[n] == b[n], f"serve_spec_sampled: request {i} position {n}: "
                                  f"{a[n]} != {b[n]} (noisy gap {gaps[n]})")
            n += 1
        compared.append(n)
    require(stats["spec_rounds"] > 0, "serve_spec_sampled: no verify round ran")
    emit({"phase": "serve_spec_sampled", "temperature": 0.8, "requests": 8,
          "speculative": stats, "sequential": plain, "tokens_compared": compared,
          "card": card})


def serve_spec_paged(card, params, prompts, paged_tokens, paged_stats):
    """The ``serve`` mix on ``paged=True, page_size=16`` at ``speculate_k=4``
    with the n-gram drafter and a self-draft: exact launch counts (the
    verify is K5-chunk), tokens against ``serve_paged``'s, ``kv.check()``."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ModelDrafter

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    runs, all_counts = {}, []
    for name, make in (("ngram", lambda: None), ("self", lambda: ModelDrafter(model, params))):
        _spec_run(model, params, [p[:32] for p in prompts[:2]], 8, make(), paged=True)
        eng, tokens, counts, stats = _spec_run(model, params, prompts, 64, make(), paged=True)
        launches = _want_spec_launches(f"serve_spec_paged {name}", eng, counts, paged=True)
        compared = _agree(f"serve_spec_paged {name} vs serve_paged", model, params, prompts,
                          tokens, paged_tokens)
        runs[name] = {**stats, **launches, "launches": counts, "tokens_compared": compared,
                      "memory": eng.snapshot()["memory"]}
        all_counts.append(counts)
    emit({"phase": "serve_spec_paged", "speculate_k": SPEC_K, "page_size": 16, "runs": runs,
          "serve_paged_same_call": paged_stats, "card": card})
    return _sum_counts(all_counts)


def generate_spec(card, params):
    """``generate_speculative`` at B 4, greedy, ``spec_k=4``, the ``generate``
    phase's prompts, with the DistilGPT2-width drafter and a self-draft, on
    the device loop and the host loop: tokens against ``generate``'s up to
    near ties; exact launch counts from ``with_stats``."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ModelDrafter

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    L = GPT2_SMALL["n_layers"]
    rows, t0_len, n_new = 4, 128, 32
    prompts = np.random.default_rng(SEED + 7).integers(0, GPT2_SMALL["vocab"],
                                                       size=(rows, t0_len))
    prompt = torch.from_numpy(prompts).cuda()
    t0 = time.perf_counter()
    want = model.generate(params, prompt, n_new)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    want = want[:, t0_len:].cpu().tolist()
    distil, distil_params = _distil_drafter()
    runs, all_counts = {}, []
    for name, draft, dparams in (("distilgpt2", distil, distil_params),
                                 ("self", model, params)):
        Ld = draft.n_layers
        for host_loop in (False, True):
            model.generate_speculative(params, prompt[:, :16], 4, draft, dparams,
                                       spec_k=SPEC_K, host_loop=host_loop)       # warm-up
            torch.cuda.synchronize()
            _zero_counters()
            t0 = time.perf_counter()
            out, st = model.generate_speculative(params, prompt, n_new, draft, dparams,
                                                 spec_k=SPEC_K, host_loop=host_loop,
                                                 with_stats=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _read_counters()
            R = st["rounds"]
            what = f"generate_spec {name} host_loop={host_loop}"
            expect = {"flash_attention_fwd": L + Ld,
                      "flash_decode_lse": Ld * (SPEC_K + 1) * R,
                      "layer_norm_fwd": (2 * L + 1) * (1 + R)
                      + (2 * Ld + 1) * (1 + R * (SPEC_K + 1))}
            for k, n in counts.items():
                require(n == expect.get(k, 0), f"{what}: {k} launched {n} times, want "
                                               f"{expect.get(k, 0)} ({R} rounds)")
            require(tuple(out.shape) == (rows, t0_len + n_new), f"{what}: {tuple(out.shape)}")
            compared = _agree(what, model, params, [p.astype(np.int32) for p in prompts],
                              out[:, t0_len:].cpu().tolist(), want)
            runs[f"{name}_{'host' if host_loop else 'device'}"] = {
                **st, "wall_s": wall, "tok_per_s": rows * n_new / wall, "launches": counts,
                "tokens_compared": compared}
            all_counts.append(counts)
    emit({"phase": "generate_spec", "rows": rows, "prompt_len": t0_len, "n_new": n_new,
          "spec_k": SPEC_K, "generate_wall_s": plain_wall,
          "generate_tok_per_s": rows * n_new / plain_wall, "runs": runs, "card": card})
    return _sum_counts(all_counts)


def spec_cross_check(card, params, prompts):
    """Two layers at GPT-2's widths: the speculative engine (n-gram drafter,
    ``speculate_k=4``, 16 new tokens, the mix's two shortest prompts) on the
    card against the same engine on ``device="cpu"`` (the plain versions),
    dense and paged."""
    from elephas_tpu_torch.models import TransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    cfg = dict(GPT2_SMALL, n_layers=2)
    order = np.argsort([len(p) for p in prompts])[:2]
    sel = [prompts[i] for i in order]
    out = {}
    for dev in ("cuda", "cpu"):
        model = TransformerLM(**cfg, device=dev)
        dev_params = _layer_slice(model, params, dev)
        for paged in (False, True):
            eng = ServingEngine(model, dev_params, n_slots=2, paged=paged, page_size=16,
                                speculate_k=SPEC_K, device=dev)
            ids = [eng.submit(p, 16) for p in sel]
            fin = eng.drain()
            if paged:
                eng.kv.check()
            require(eng.snapshot()["fastpath"]["spec_rounds"] > 0,
                    f"spec_cross_check {dev}: no verify round ran")
            out[(dev, paged)] = [fin[r].tokens for r in ids]
    compared = {("paged" if paged else "dense"): _agree(
        f"spec_cross_check {'paged' if paged else 'dense'}", model, dev_params, sel,
        out[("cuda", paged)], out[("cpu", paged)]) for paged in (False, True)}
    emit({"phase": "spec_cross_check", "layers": 2, "requests": [int(i) for i in order],
          "compared": compared, "cpu": out[("cpu", False)], "gpu": out[("cuda", False)],
          "card": card})


# -- phases 14 to 18: the mixture-of-experts LM -------------------------------------

# Mixtral-8x7B-v0.1's published widths (its config.json), with the MoE
# settings models/hf_import.py applies (capacity E/k: exact routing); depth
# and the cache length are cut to fit one 80 GB card, nothing else
MIXTRAL_8X7B = dict(vocab=32000, d_model=4096, n_heads=32, n_kv_heads=8,
                    d_ff=14336, n_experts=8, k=2, capacity_factor=4.0,
                    aux_weight=0.02, activation="swiglu", ffn_bias=False,
                    norm="rmsnorm", norm_eps=1e-5, pos_encoding="rotary",
                    rope_theta=1e6, attn_bias=False, tie_embeddings=False,
                    moe_dispatch="gmm", max_len=2048)
MOE_SERVE_LAYERS = 4
MOE_TRAIN_LAYERS = 2
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
GMM_TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-3}


def draw_params(model, seed: int):
    """Random weights for ``model`` drawn on the card from a seeded
    ``torch.Generator``, one layer at a time, with ``init``'s distributions
    (glorot-uniform weights, N(0, 0.02) embeddings, unit norm scales, zero
    biases): ``model.init`` would draw billions of float64 numbers on the
    host at these widths."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    block = set(model._block_keys())
    out = {}
    for name, shape in model.param_shapes().items():
        t = torch.empty(shape, dtype=torch.float32, device="cuda")
        if name in ("ln1_s", "ln2_s", "lnf_s"):
            t.fill_(1.0)
        elif name.startswith(("ln", "b")):
            t.zero_()
        elif name in ("tok", "pos"):
            t.normal_(0.0, 0.02, generator=gen)
        else:
            limit = (6.0 / (shape[-2] + shape[-1])) ** 0.5
            for layer in (t if name in block else [t]):
                layer.uniform_(-limit, limit, generator=gen)
        out[name] = t
    moe = getattr(model, "moe", None)
    for name in (moe.expert_keys() if moe is not None else ()):
        out[name] = out[name].to(moe.param_dtype)
    return out


def _layer_slice(model, params, device):
    """``params`` cut to ``model``'s depth (the first layers), on ``device``."""
    shapes = model.param_shapes()
    return {k: v[:shapes[k][0]].to(device) for k, v in params.items()}


def _moe_layout(n_tokens, gen, tm=128, hungry=None):
    """A real routing of ``n_tokens`` random tokens through a random Mixtral
    router (experts never chosen when ``hungry`` is set): the tile layout
    ``(tok_of_row, gmap)`` the grouped matmuls run on."""
    from elephas_tpu_torch.parallel.expert import MoEFeedForward, _top_k_select

    cfg = MIXTRAL_8X7B
    moe = MoEFeedForward(cfg["d_model"], cfg["d_ff"], cfg["n_experts"], k=cfg["k"],
                         capacity_factor=cfg["capacity_factor"], activation="swiglu",
                         bias=False)
    x = torch.randn(n_tokens, cfg["d_model"], device="cuda", generator=gen)
    wg = torch.randn(cfg["d_model"], cfg["n_experts"], device="cuda", generator=gen) * 0.02
    if hungry is not None:
        x[:, 0] = 1.0
        wg[0, hungry] = -1e3
    gates = torch.softmax(x @ wg, dim=-1)
    eidx, slot, _, _ = _top_k_select(gates, moe.capacity(n_tokens), moe.k)
    _, _, tok_of_row, gmap = moe._tile_layout(eidx, slot, n_tokens, tm)
    return x, tok_of_row, gmap


def _gmm_bound(m_pad, K, N, gmap, itemsize, out_itemsize, ops_rate):
    """Least time of one grouped product: lhs, each tiled expert's weight
    panel and the output once each over 3.35 TB/s, or 2 M K N operations
    over ``ops_rate`` (float32 on the tensor cores: 3xTF32, three TF32
    products, ``ops_rate`` = 494.7 / 3 TFLOP/s); ``(ms,
    "bytes"|"operations")``."""
    experts = len(set(gmap.tolist()))
    n_bytes = (m_pad * K + experts * K * N) * itemsize + m_pad * N * out_itemsize
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m_pad * K * N / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _tgmm_bound(m_pad, K, N, gmap, itemsize, ops_rate):
    """Least time of one ``tgmm``: lhs ``[M, K]`` and g ``[M, N]`` read once
    and the float32 ``[E', K, N]`` output written once (E' experts with a
    tile) over 3.35 TB/s, or 2 M K N operations over ``ops_rate``; ``(ms,
    "bytes"|"operations")``."""
    experts = len(set(gmap.tolist()))
    n_bytes = (m_pad * K + m_pad * N) * itemsize + experts * K * N * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m_pad * K * N / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _runs(gmap, tm):
    """``(expert, first row, end row)`` of each expert's contiguous rows."""
    from elephas_tpu_torch.ops.grouped_matmul import _runs as runs

    return [(e, a * tm, b * tm) for e, a, b in runs(gmap)]


def _tgmm_bmm(lhs, g, gmap):
    """The ``tgmm`` yardstick: one ``torch.bmm`` over the row tiles and a sum
    over each expert's tiles, as a function of no arguments."""
    nm, tm = gmap.numel(), lhs.shape[0] // gmap.numel()
    runs = [(e, a // tm, b // tm) for e, a, b in _runs(gmap, tm)]
    lb = lhs.reshape(nm, tm, -1).transpose(1, 2)
    gb = g.reshape(nm, tm, -1)

    def run():
        per_tile = torch.bmm(lb, gb)
        return torch.stack([per_tile[a:b].sum(0) for _, a, b in runs])
    return run


def _tgmm_grouped_mm(a16, g16, gmap, E):
    """``torch._grouped_mm`` over the contraction in bf16 (``mat_a =
    lhs.T``, ``offs`` each expert's row end): the same grouped weight
    gradient ``[E, K, N]`` as ``tgmm``, rounded to a bf16 output. ``(ms,
    note)``: ms ``None`` and the error in the note where the call is missing
    or refuses the layout."""
    from elephas_tpu_torch.ops.grouped_matmul import tgmm_reference

    if not hasattr(torch, "_grouped_mm"):
        return None, "none: torch._grouped_mm absent"
    tm = a16.shape[0] // gmap.numel()
    ends = (torch.searchsorted(gmap, torch.arange(E, dtype=gmap.dtype, device=gmap.device),
                               right=True) * tm).to(torch.int32)
    try:
        out = torch._grouped_mm(a16.T, g16, offs=ends)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as exc:   # a yardstick only: recorded, not fatal
        return None, f"none: torch._grouped_mm refused mat_a = lhs.T with offs: {exc}"
    want = tgmm_reference(a16, g16, gmap, E)
    rel = float((out.double() - want.double()).abs().max() / want.double().abs().max())
    del out, want
    ms = device_ms(lambda: torch._grouped_mm(a16.T, g16, offs=ends), [()], n_iter=4)
    return ms, (f"torch._grouped_mm (bf16, mat_a = lhs.T, offs over the rows, bf16 output; "
                f"max|diff|/max|plain| {rel:.2e})")


def check_grouped_matmul(card):
    """K6-gmm (``gmm``, ``gmm_t``) and K6-tgmm against their plain versions
    on the card, tolerance max |diff| / max |plain| (float32 2e-5: sums over
    up to 14336 terms in another order; bf16 outputs 8e-3, one bf16 rounding
    of the same float32 sum), each case timed beside the plain version, a
    library yardstick the port never calls and the bound."""
    from elephas_tpu_torch.ops import grouped_matmul as G

    cfg = MIXTRAL_8X7B
    D, Fd, E = cfg["d_model"], cfg["d_ff"], cfg["n_experts"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    f32, bf16 = torch.float32, torch.bfloat16

    def weights(*shape, dtype=f32):
        limit = (6.0 / (shape[-2] + shape[-1])) ** 0.5
        return (torch.rand(shape, device="cuda", generator=gen) * 2 - 1).mul_(limit).to(dtype)

    def errors(got, want):
        """``(max |diff|, max |diff| / max |plain|)``."""
        diff = float((got.double() - want.double()).abs().max())
        return diff, diff / max(float(want.double().abs().max()), 1e-30)

    def lib_gmm(lhs, w, gmap, transpose):
        tm = lhs.shape[0] // gmap.numel()
        runs = _runs(gmap, tm)
        out = torch.empty(lhs.shape[0], w.shape[1] if transpose else w.shape[2],
                          dtype=lhs.dtype, device="cuda")

        def run():
            for e, a, b in runs:
                torch.matmul(lhs[a:b], w[e].T if transpose else w[e], out=out[a:b])
        return run

    def grouped_mm_yardstick(lhs, w, gmap):
        """``torch._grouped_mm`` in bf16 over the same rows, where the
        card's torch has it (B column-major per group, as it wants)."""
        if not hasattr(torch, "_grouped_mm"):
            return None, "torch._grouped_mm absent"
        tm = lhs.shape[0] // gmap.numel()
        ends = torch.tensor([b for _, _, b in _runs(gmap, tm)], dtype=torch.int32,
                            device="cuda")
        a = lhs.to(bf16)
        b = w.to(bf16).transpose(1, 2).contiguous().transpose(1, 2)
        b = b[sorted({e for e, _, _ in _runs(gmap, tm)})]
        ms = device_ms(lambda: torch._grouped_mm(a, b, offs=ends), [()], n_iter=10)
        return ms, "torch._grouped_mm (bf16, per-expert offsets)"

    checks, timings = [], []

    def case(name, lhs, w, g, gmap, dtype):
        """gmm(lhs, w), gmm_t(g, w) and tgmm(lhs, g) at one layout, checked
        and timed."""
        K, N = w.shape[1], w.shape[2]
        m_pad, tm = lhs.shape[0], lhs.shape[0] // gmap.numel()
        tol = GMM_TOL[dtype]
        row = {"case": name, "M_pad": m_pad, "K": K, "N": N, "tm": tm,
               "dtype": str(dtype), "tiles_per_expert": np.bincount(
                   gmap.cpu().numpy(), minlength=E).tolist()}
        errs, abs_errs = {}, {}
        got, want = G.gmm(lhs, w, gmap), G.gmm_reference(lhs, w, gmap)
        abs_errs["gmm"], errs["gmm"] = errors(got, want)
        got, want = G.gmm_t(g, w, gmap), G.gmm_reference(g, w, gmap, True)
        abs_errs["gmm_t"], errs["gmm_t"] = errors(got, want)
        got = G.tgmm(lhs, g, gmap, E)
        want = G.tgmm_reference(lhs, g, gmap, E)
        abs_errs["tgmm"], errs["tgmm"] = errors(got, want)
        same_bits = torch.equal(got, G.tgmm(lhs, g, gmap, E))
        empty = [e for e in range(E) if e not in set(gmap.tolist())]
        if dtype == bf16:
            got16 = G.tgmm(lhs, g, gmap, E, bf16)
            abs_errs["tgmm_bf16_out"], errs["tgmm_bf16_out"] = errors(got16, want.to(bf16))
        torch.cuda.synchronize()
        for k_, e in errs.items():
            tol_k = GMM_TOL[f32] if k_ == "tgmm" else tol
            require(e <= tol_k, f"grouped_matmul {name} {k_}: max|diff|/max|plain| "
                                f"{e} > {tol_k}")
        require(all(bool((got[e] == 0).all()) for e in empty),
                f"grouped_matmul {name}: an expert without rows got a nonzero gradient")
        require(same_bits, f"grouped_matmul {name}: two tgmm launches differ")
        row.update({"max_rel_err": errs, "max_abs_err": abs_errs, "tol": tol,
                    "tgmm_tol": GMM_TOL[f32], "experts_without_rows": empty,
                    "tgmm_same_bits": same_bits})
        checks.append(row)
        del got, want
        isz = lhs.element_size()
        rate = BF16_OPS_PER_S if dtype == bf16 else F32_OPS_PER_S
        # all three run on the tensor cores (3xTF32 for float32): bound at
        # that rate, the SIMT rate's beside it
        mma_rate = BF16_OPS_PER_S if dtype == bf16 else TF32_OPS_PER_S / 3
        n_it = 10 if m_pad * K * N < 1e11 else 4
        for fn_name, fn, plain, lib, M_, K_, N_, out_isz in (
                ("gmm", lambda: G.gmm(lhs, w, gmap),
                 lambda: G.gmm_reference(lhs, w, gmap), lib_gmm(lhs, w, gmap, False),
                 m_pad, K, N, isz),
                ("gmm_t", lambda: G.gmm_t(g, w, gmap),
                 lambda: G.gmm_reference(g, w, gmap, True), lib_gmm(g, w, gmap, True),
                 m_pad, N, K, isz),
                ("tgmm", lambda: G.tgmm(lhs, g, gmap, E),
                 lambda: G.tgmm_reference(lhs, g, gmap, E), _tgmm_bmm(lhs, g, gmap),
                 K, m_pad, N, 4)):
            ms = device_ms(fn, [()], n_iter=n_it)
            plain_ms = device_ms(plain, [()], n_iter=n_it)
            lib_ms = device_ms(lib, [()], n_iter=n_it)
            if fn_name == "tgmm":
                bms, by = _tgmm_bound(m_pad, K, N, gmap, isz, mma_rate)
                simt_ms = _tgmm_bound(m_pad, K, N, gmap, isz, rate)[0]
            else:
                bms, by = _gmm_bound(M_, K_, N_, gmap, isz, out_isz, mma_rate)
                simt_ms = _gmm_bound(M_, K_, N_, gmap, isz, out_isz, rate)[0]
            t = {"case": name, "kernel": fn_name, "ms": ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                 "simt_bound_ms": simt_ms, "tflops": 2.0 * m_pad * K * N / ms / 1e9}
            if fn_name == "gmm" and name in ("decode_w1", "train_w1"):
                t["grouped_mm_bf16_ms"], t["grouped_mm_note"] = grouped_mm_yardstick(
                    lhs, w, gmap)
            if fn_name == "tgmm" and name in ("decode_w1_bf16", "train_w1"):
                # tgmm on the same rows in bf16, beside torch._grouped_mm
                a16, g16 = lhs.to(bf16), g.to(bf16)
                if dtype != bf16:
                    t["bf16_ms"] = device_ms(lambda: G.tgmm(a16, g16, gmap, E), [()], n_it)
                    t["bf16_bound_ms"] = _tgmm_bound(m_pad, K, N, gmap, 2, BF16_OPS_PER_S)[0]
                t["grouped_mm_bf16_ms"], t["grouped_mm_note"] = _tgmm_grouped_mm(
                    a16, g16, gmap, E)
                del a16, g16
            timings.append(t)

    # the serving decode layout: 8 rows routed, k 2, E 8, tm 128 -> 1152 rows
    x, tok, gmap = _moe_layout(8, gen)
    from elephas_tpu_torch.parallel.expert import _gather_rows

    lhs = _gather_rows(x, tok)
    w1 = weights(E, D, Fd)
    g = torch.randn(lhs.shape[0], Fd, device="cuda", generator=gen)
    case("decode_w1", lhs, w1, g, gmap, f32)
    live = int((tok < 8).sum())
    decode_live = {"live_rows": live, "M_pad": lhs.shape[0],
                   "live_share": live / lhs.shape[0]}
    case("decode_w1_bf16", lhs.to(bf16), w1.to(bf16), g.to(bf16), gmap, bf16)
    del lhs, g
    # the training layout: B 4 x T 1024 tokens -> 9216 rows; w1 and w2 shapes
    x, tok, gmap = _moe_layout(4096, gen)
    xs = _gather_rows(x, tok)
    h = torch.randn(xs.shape[0], Fd, device="cuda", generator=gen)
    case("train_w1", xs, w1, h, gmap, f32)
    del w1
    w2 = weights(E, Fd, D)
    dout = torch.randn(xs.shape[0], D, device="cuda", generator=gen)
    case("train_w2", h, w2, dout, gmap, f32)
    del w2, xs, h, dout
    # a hungry expert: expert 3 never chosen, only its all-sentinel tile
    x, tok, gmap = _moe_layout(64, gen, hungry=3)
    require(bool((gmap == 3).sum() == 1) and bool((tok[gmap.repeat_interleave(128) == 3] == 64).all()),
            "grouped_matmul: the hungry expert's layout is not one all-sentinel tile")
    lhs = _gather_rows(x, tok)
    case("hungry_expert", lhs, weights(E, D, 512), torch.randn(lhs.shape[0], 512,
         device="cuda", generator=gen), gmap, f32)
    # ragged K and N, no multiple of any tile
    gmap = torch.tensor([0, 1, 1, 2], dtype=torch.int32, device="cuda")
    lhs = torch.randn(512, 200, device="cuda", generator=gen)
    case("ragged_k200_n100", lhs, weights(3, 200, 100),
         torch.randn(512, 100, device="cuda", generator=gen), gmap, f32)
    case("ragged_k200_n100_bf16", lhs.to(bf16), weights(3, 200, 100, dtype=bf16),
         torch.randn(512, 100, device="cuda", generator=gen).to(bf16), gmap, bf16)

    f32_checks = [c for c in checks if c["dtype"] == str(f32)]
    worst = {n: max(c["max_rel_err"][n] for c in f32_checks) for n in ("gmm", "gmm_t", "tgmm")}
    worst_abs = {n: max(c["max_abs_err"][n] for c in f32_checks)
                 for n in ("gmm", "gmm_t", "tgmm")}
    rows = []
    # gmm twice: at its serving decode layout (its main path's launches are
    # serve_moe's) and at the training layout (train_moe's)
    for name, kernel, main_case, repl in (
            ("gmm", "gmm", "decode_w1", "elephas_tpu/ops/grouped_matmul.py:237"),
            ("gmm_train", "gmm", "train_w1", "elephas_tpu/ops/grouped_matmul.py:237"),
            ("gmm_t", "gmm_t", "train_w1", "elephas_tpu/ops/grouped_matmul.py:237"),
            ("tgmm", "tgmm", "train_w1", "elephas_tpu/ops/grouped_matmul.py:321")):
        t = next(t for t in timings if t["case"] == main_case and t["kernel"] == kernel)
        rows.append({"name": name, "counter": kernel, "route": "cuda",
                     "source": "elephas_tpu_torch/ops/csrc/grouped_matmul.cu",
                     "replaces": repl, "max_abs_err": worst_abs[kernel],
                     "max_rel_err": worst[kernel],
                     "error_measure": "worst of the float32 cases; max_rel_err is "
                                      "max |diff| / max |plain|, held to its tolerance",
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "simt_bound_ms": t["simt_bound_ms"],
                     "library_ms": t["library_ms"],
                     "library": ("per-tile torch.bmm + per-expert sum" if name == "tgmm"
                                 else "per-expert torch.matmul over contiguous rows"),
                     "timed_shape": {k_: c[k_] for c in checks if c["case"] == main_case
                                     for k_ in ("M_pad", "K", "N", "tm", "dtype")},
                     **{k_: t[k_] for k_ in ("bf16_ms", "bf16_bound_ms", "grouped_mm_bf16_ms",
                                             "grouped_mm_note") if k_ in t}})
    emit({"phase": "kernel", "kernel": "grouped_matmul", "checks": checks,
          "timing": timings, "decode_layout": decode_live, "card": card})
    return rows


def serve_moe(card):
    """The Mixtral-width MoE LM (4 layers, float32, ``moe_dispatch="gmm"``)
    behind ``ServingEngine(n_slots=8)``: 16 greedy requests of 32-256-token
    prompts and 32 new tokens; exactly 3L ``gmm`` launches per decode step
    and per prefill insert, L flash-decode launches per decode step, no
    ``gmm_t``/``tgmm``; then ten decode steps under the profiler."""
    from elephas_tpu_torch.models import MoETransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    L = MOE_SERVE_LAYERS
    t0 = time.perf_counter()
    model = MoETransformerLM(**dict(MIXTRAL_8X7B, n_layers=L), device="cuda")
    params = draw_params(model, SEED + 20)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen = np.random.default_rng(SEED + 21)
    V = MIXTRAL_8X7B["vocab"]
    prompts = [gen.integers(0, V, size=int(n)).astype(np.int32)
               for n in gen.integers(32, 257, size=16)]
    warm = ServingEngine(model, params, n_slots=8, device="cuda")
    _drain(warm, [p[:32] for p in prompts[:2]], 4)
    del warm
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(model, params, n_slots=8, device="cuda")
    _zero_counters()
    fin, wall = _drain(eng, prompts, 32)
    counts = _read_counters()
    snap = eng.snapshot()
    steps, inserts = snap["engine"]["decode_steps"], snap["engine"]["prefills"]
    require(steps > 0 and counts["gmm"] == 3 * L * (steps + inserts),
            f"serve_moe: gmm launched {counts['gmm']} times, want 3 x {L} x "
            f"({steps} decode steps + {inserts} inserts)")
    require(counts["flash_decode_lse"] == L * steps,
            f"serve_moe: flash decode launched {counts['flash_decode_lse']} times, "
            f"want {L} x {steps}")
    require(counts["gmm_t"] + counts["tgmm"] + counts["layer_norm_fwd"] == 0,
            f"serve_moe: unexpected launches {counts}")
    tokens = [f.tokens for f in fin]
    for t in tokens:
        require(all(0 <= x < V for x in t), "serve_moe: token out of range")
    stats = _serving_stats(snap, fin, wall)
    peak = torch.cuda.max_memory_allocated()
    eng2 = ServingEngine(model, params, n_slots=8, device="cuda")
    for p in prompts[:8]:
        eng2.submit(p, 32)
    while eng2.kv.free_slots:
        eng2.step()

    def run():
        require(eng2.step() == "decode", "serve_moe profile window left the decode loop")

    prof = profiled(run, 10, top_n=10)
    del eng2
    emit({"phase": "serve_moe", "model": "Mixtral-8x7B widths, 4 of 32 layers "
          "(random weights, seed 20)", "dtype": "float32", "max_len": MIXTRAL_8X7B["max_len"],
          "requests": 16, "new_tokens_each": 32, "prompt_lens": [int(len(p)) for p in prompts],
          "decode_steps": steps, "inserts": inserts, "launches": counts,
          "launches_per_decode_step_and_insert": {"gmm": counts["gmm"] / (steps + inserts)},
          "launches_per_decode_step": {"flash_decode_lse": counts["flash_decode_lse"] / steps},
          **stats, "weights_setup_s": setup_s, "peak_mem_gb": peak / 1e9,
          "profiled_decode": prof, "card": card})
    return model, params, prompts, tokens, counts, stats


def serve_moe_paged(card, model, params, prompts, dense_tokens, dense_stats):
    """The ``serve_moe`` mix on ``paged=True, page_size=16``: L paged-decode
    launches per decode step and 3L ``gmm`` per step and insert, greedy tokens
    equal to the dense MoE run's up to the first near tie."""
    from elephas_tpu_torch.serving import ServingEngine

    L = MOE_SERVE_LAYERS
    eng = ServingEngine(model, params, n_slots=8, paged=True, page_size=16, device="cuda")
    _zero_counters()
    fin, wall = _drain(eng, prompts, 32)
    counts = _read_counters()
    snap = eng.snapshot()
    steps, inserts = snap["engine"]["decode_steps"], snap["engine"]["prefills"]
    eng.kv.check()
    require(steps > 0 and counts["paged_flash_decode_lse"] == L * steps,
            f"serve_moe_paged: paged decode launched {counts['paged_flash_decode_lse']} "
            f"times, want {L} x {steps}")
    require(counts["paged_flash_chunk"] == L * inserts,
            f"serve_moe_paged: paged chunk launched {counts['paged_flash_chunk']} times")
    require(counts["gmm"] == 3 * L * (steps + inserts),
            f"serve_moe_paged: gmm launched {counts['gmm']} times")
    require(counts["flash_decode_lse"] + counts["gmm_t"] + counts["tgmm"] == 0,
            f"serve_moe_paged: unexpected launches {counts}")
    tokens = [f.tokens for f in fin]
    compared = _agree("serve_moe_paged vs serve_moe", model, params, prompts, tokens,
                      dense_tokens)
    emit({"phase": "serve_moe_paged", "page_size": 16, "decode_steps": steps,
          "inserts": inserts, "launches": counts,
          "launches_per_decode_step": {"paged_flash_decode_lse":
                                       counts["paged_flash_decode_lse"] / steps},
          **_serving_stats(snap, fin, wall), "dense_same_call": dense_stats,
          "tokens_compared_with_dense": compared, "memory": snap["memory"],
          "card": card})
    return counts


def moe_cross_check(card, params, prompts):
    """Full width, one layer: two requests of the mix, 8 new tokens, on the
    card and on a ``device="cpu"`` engine from the same weights, equal up
    to each request's first near tie."""
    from elephas_tpu_torch.models import MoETransformerLM
    from elephas_tpu_torch.serving import ServingEngine

    order = np.argsort([len(p) for p in prompts])[:2]
    sel = [prompts[i] for i in order]
    out = {}
    for dev in ("cuda", "cpu"):
        model = MoETransformerLM(**dict(MIXTRAL_8X7B, n_layers=1), device=dev)
        p = _layer_slice(model, params, dev)
        eng = ServingEngine(model, p, n_slots=2, device=dev)
        ids = [eng.submit(q, 8) for q in sel]
        fin = eng.drain()
        out[dev] = (model, p, [fin[r].tokens for r in ids])
    cpu_model, cpu_params, cpu = out["cpu"]
    compared = _agree("moe_cross_check", cpu_model, cpu_params, sel, out["cuda"][2], cpu)
    emit({"phase": "moe_cross_check", "layers": 1, "requests": [int(i) for i in order],
          "compared": compared, "cpu": cpu, "gpu": out["cuda"][2], "card": card})


def train_moe(card):
    """Two Mixtral-width layers, float32, trained by ``build_lm_train_step(
    model, None, adam_compact(1e-3), attn="flash")`` on one fixed batch of
    4 x 1024 tokens: 2 warm-up and 3 timed steps with finite, falling
    losses; per timed step exactly 5L gmm, 3L gmm_t, 3L tgmm and L of each
    rope-on-load flash-attention kernel (Mixtral is rotary), none of the
    plain ones."""
    from elephas_tpu_torch.models import (MoETransformerLM, adam_compact,
                                          build_lm_train_step, make_lm_batches)

    L = MOE_TRAIN_LAYERS
    model = MoETransformerLM(**dict(MIXTRAL_8X7B, n_layers=L), device="cuda")
    params = draw_params(model, SEED + 22)
    B, T = 4, 1024
    rows = np.random.default_rng(SEED + 23).integers(0, MIXTRAL_8X7B["vocab"],
                                                     size=(B, T + 1))
    batch = tuple(torch.from_numpy(a).cuda() for a in make_lm_batches(rows))
    step, opt_init = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")
    state = opt_init(params)
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps = 3
    _zero_counters()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        params, state, loss = step(params, state, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    require(all(np.isfinite(losses)), f"train_moe: non-finite loss in {losses}")
    require(losses[-1] < losses[0], f"train_moe: loss did not fall: {losses}")
    want = {"gmm": 5 * L, "gmm_t": 3 * L, "tgmm": 3 * L, "flash_attention_rope_fwd": L,
            "flash_attention_rope_dq": L, "flash_attention_rope_dkv": L,
            "flash_attention_fwd": 0, "flash_attention_dq": 0, "flash_attention_dkv": 0,
            "layer_norm_fwd": 0}
    for name, per_step in want.items():
        require(counts[name] == per_step * n_steps,
                f"train_moe: {name} launched {counts[name]} times in {n_steps} "
                f"steps, want {per_step} per step")
    prof = profiled(lambda: step(params, state, *batch), 1, top_n=12)
    emit({"phase": "train_moe", "model": "Mixtral-8x7B widths, 2 of 32 layers "
          "(random weights, seed 22)", "dtype": "float32",
          "optimizer": "adam_compact(1e-3)", "attn": "flash", "batch": B, "seq_len": T,
          "warmup_steps": 2, "timed_steps": n_steps, "ms_per_step": wall * 1e3 / n_steps,
          "tokens_per_s": n_steps * B * T / wall, "peak_mem_gb": peak / 1e9,
          "losses": losses, "launches": counts,
          "launches_per_step": {k: v / n_steps for k, v in counts.items()},
          "profiled_step": prof, "card": card})
    return model, params, counts


def train_moe_cross_check(card, params):
    """One layer at full width, B 1, T 64: the loss and every gradient on
    the card against ``device="cpu"`` from the same weights, at
    ``train_cross_check``'s tolerances (loss rtol 1e-4; each gradient within
    1e-3 of its scale, floored at 1e-4 of the largest entry)."""
    from elephas_tpu_torch.models import (MoETransformerLM, adam_compact,
                                          build_lm_train_step, make_lm_batches)

    rows = np.random.default_rng(SEED + 24).integers(0, MIXTRAL_8X7B["vocab"],
                                                     size=(1, 65))
    batch = make_lm_batches(rows)
    out = {}
    for dev in ("cuda", "cpu"):
        model = MoETransformerLM(**dict(MIXTRAL_8X7B, n_layers=1), device=dev)
        p = _layer_slice(model, params, dev)
        step, _ = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")
        loss, grads = step.grad(p, *batch)
        out[dev] = (float(loss), {k: g.cpu().double() for k, g in grads.items()})
        del p, grads
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    require(loss_rel <= 1e-4, f"train_moe_cross_check: loss {lg} vs cpu {lc}")
    floor = 1e-4 * max(float(g.abs().max()) for g in gc.values())
    grad_rel = {k: float((gg[k] - gc[k]).abs().max()) / max(float(gc[k].abs().max()), floor)
                for k in gc}
    worst = max(grad_rel, key=grad_rel.get)
    require(grad_rel[worst] <= 1e-3, f"train_moe_cross_check: gradient of {worst} off "
                                     f"by {grad_rel[worst]} of its scale")
    emit({"phase": "train_moe_cross_check", "layers": 1, "batch": 1, "seq_len": 64,
          "loss_gpu": lg, "loss_cpu": lc, "loss_rel_diff": loss_rel, "loss_rtol": 1e-4,
          "grad_err_rel_to_scale": grad_rel, "scale_floor": floor, "grad_tol": 1e-3,
          "card": card})


# -- phases 19 to 22: the MLP fit -------------------------------------------------

# The reference's flagship example (examples/mnist_mlp_spark.py:37-45) with a
# logits head and from_logits=True: the Keras JSON written once with Keras
# and committed in the port (the card has no Keras), 65536 MNIST-shaped
# samples (bench.py:1695), batch 128, 8 workers (the example's local[8]),
# synchronous, 4 epochs, validation_split 0.1. Nothing is cut.
MNIST_JSON = "elephas_tpu_torch/configs/mnist_mlp_logits.json"
MLP_FIT = dict(samples=65536, held_out=2048, batch=128, workers=8, epochs=4,
               validation_split=0.1)


def mnist_like(n_train: int, n_test: int):
    """The class-blob generator of ``examples/_datasets.py:26-37`` with its
    seed: Gaussian blobs around ten prototypes in pixel space, clipped to
    [0, 1], one-hot labels; (train, test)."""
    rng = np.random.default_rng(0)
    protos = rng.uniform(0, 1, size=(10, 784)).astype("float32")

    def make(n):
        labels = rng.integers(0, 10, size=n)
        x = protos[labels] + 0.3 * rng.normal(size=(n, 784)).astype("float32")
        return np.clip(x, 0, 1).astype("float32"), np.eye(10, dtype="float32")[labels]

    return make(n_train), make(n_test)


def _mlp_steps(n: int, workers: int, batch: int, split: float):
    """``(S, Sv)``: training and validation batches per epoch of one worker
    holding ``n / workers`` samples (the engine's geometry)."""
    per = n // workers
    n_val = int(per * split)
    return -(-(per - n_val) // batch), -(-n_val // batch)


def _xent_inputs(gen, B, C, dtype):
    x = torch.from_numpy((gen.normal(size=(B, C)) * 3).astype(np.float32)).to("cuda", dtype)
    y = torch.zeros((B, C), device="cuda")
    y[torch.arange(B), torch.from_numpy(gen.integers(0, C, size=B)).cuda()] = 1.0
    y[0] = 0.0                      # a zero-label row: the kernel gives 0
    y[1, :3] += 0.5                 # a row summing to 2.5
    g = torch.from_numpy(gen.normal(size=B).astype(np.float32)).cuda()
    return x, y, g


EMPTY_KERNEL_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


def empty_kernel_ms(blocks: int, threads: int, n_iter: int = 200) -> float:
    """The launch floor: an empty kernel of ``blocks`` x ``threads``, built
    by the kernels' own builder (a library named by its source's hash) and
    timed by :func:`device_ms`, the loop every kernel time here comes from."""
    import ctypes

    from elephas_tpu_torch.ops import _build

    src = _build.BUILD_DIR / "empty_kernel.cu"
    if not src.exists() or src.read_text() != EMPTY_KERNEL_CU:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(EMPTY_KERNEL_CU)
    lib = _build.load("empty_kernel", {"empty_launch": [ctypes.c_int, ctypes.c_int,
                                                        ctypes.c_void_p]}, src=src)

    def run():
        _build.check(lib, lib.empty_launch(blocks, threads,
                                           torch.cuda.current_stream().cuda_stream),
                     "empty_kernel")
    return device_ms(run, [()], n_iter)


def l2_sets(set_bytes: int, most: int = 64) -> int:
    """Input sets of ``set_bytes`` each that together hold twice the card's
    L2, so a timing loop cycling through them reads device memory; at most
    ``most``, where sets of under 2 L2 / ``most`` bytes (the fit's rows)
    are read from the L2, as the step that makes them leaves them."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    return max(1, min(most, -(-2 * l2 // set_bytes)))


def xent_cases():
    """K1's cases: the MLP fit's [1024, 10] (ragged [1000, 10]), the host
    path's (``fit_host``: a worker's batch [128, 10], its last training
    batch [51, 10] and last validation batch [77, 10]), the estimator's
    (``ml_mlp``, and ``fit_cnn``'s: every padded block of 8 workers'
    batches of 64, [512, 10]), the wide
    [4096, 50257] (float32 and bf16 logits), one each side of every route
    boundary (warp / cluster at C 1024, cluster / stream at the cluster's
    capacity), and of the warp route's switch from dividing by the row's
    sum to multiplying by its inverse (C 128 / 129)."""
    from elephas_tpu_torch.ops.fused_xent import cluster_capacity

    f32, bf = torch.float32, torch.bfloat16
    cap = cluster_capacity(4)
    per = HOST_FIT["samples"] // HOST_FIT["workers"]
    n_train = int(np.floor(per * (1.0 - HOST_FIT["validation_split"])))
    B = HOST_FIT["batch"]
    return [("main", 1024, 10, f32), ("ragged", 1000, 10, f32),
            ("host", B, 10, f32), ("host_tail", n_train % B, 10, f32),
            ("host_val_tail", (per - n_train) % B, 10, f32),
            ("ml_mlp", ML_MLP["workers"] * ML_MLP["batch"], 10, f32), ("wide", 4096, 50257, f32),
            ("main_bf16", 1024, 10, bf), ("wide_bf16", 4096, 50257, bf),
            ("c128", 1024, 128, f32), ("c129", 1024, 129, f32), ("c1024", 4096, 1024, f32),
            ("c1025", 4096, 1025, f32), ("cluster_cap", 64, cap, f32),
            ("stream", 64, cap + 1, f32)]


def check_fused_xent(card):
    """K1-fwd and K1-bwd against their plain versions (loss atol = rtol =
    1e-5: float32 row sums in another order; dx 1e-6 in float32, one bf16
    ulp, 2**-8, in bf16) over :func:`xent_cases`, each run twice for the
    same bits, its route named, timed beside the plain versions and
    ``F.cross_entropy(x, y, reduction="none")`` with probability targets
    (its autograd backward for K1-bwd), a yardstick the port never calls,
    the bound and its share, and the launch floor: an empty kernel at the
    fit shape's grid under the same timing loop."""
    from elephas_tpu_torch.ops.fused_xent import (ROUTES, _vec_max, fused_xent_bwd,
                                                  fused_xent_bwd_reference, fused_xent_fwd,
                                                  fused_xent_fwd_reference, launch_shape,
                                                  xent_plan)

    F = torch.nn.functional
    gen = np.random.default_rng(SEED + 30)
    out, worst = {"fwd": [], "bwd": []}, {"fwd": 0.0, "bwd": 0.0}
    rows = {}
    fit_grid = launch_shape(1024, 10, torch.float32, xent_plan(10, 4))[:2]
    floor = empty_kernel_ms(*fit_grid)
    for name, B, C, dtype in xent_cases():
        sets = [_xent_inputs(gen, B, C, dtype)]
        sets += [_xent_inputs(gen, B, C, dtype)
                 for _ in range(l2_sets(sum(t.nbytes for t in sets[0])) - 1)]
        # the library call wants targets in the logits' dtype
        lib_sets = [(xi, yi.to(dtype), gi) for xi, yi, gi in sets]
        x, y, g = sets[0]
        plan = xent_plan(C, x.element_size(), _vec_max(x, y))
        fwd, bwd = fused_xent_fwd(x, y), fused_xent_bwd(x, y, g)
        same = torch.equal(fwd, fused_xent_fwd(x, y)) and torch.equal(bwd, fused_xent_bwd(x, y, g))
        torch.cuda.synchronize()
        err_f, ok_f = _allclose_err(fwd, fused_xent_fwd_reference(x, y), 1e-5)
        tol_b = 1e-6 if dtype == torch.float32 else 2.0 ** -8
        err_b, ok_b = _allclose_err(bwd.float(), fused_xent_bwd_reference(x, y, g).float(),
                                    tol_b)
        require(bool(torch.isfinite(fwd).all() and torch.isfinite(bwd.float()).all()),
                f"fused_xent {name}: not finite")
        require(ok_f and float(fwd[0]) == 0.0,
                f"fused_xent_fwd {name}: max abs err {err_f} beyond 1e-5 (row 0 {float(fwd[0])})")
        require(ok_b, f"fused_xent_bwd {name}: max abs err {err_b} beyond {tol_b}")
        require(same, f"fused_xent {name}: a second run gave other bits")
        worst["fwd"], worst["bwd"] = max(worst["fwd"], err_f), max(worst["bwd"], err_b)

        n_iter = 100 if B * C < 1e6 else 20
        xs = x.element_size()
        f_ms = device_ms(lambda x, y, g: fused_xent_fwd(x, y), sets, n_iter)
        f_plain = device_ms(lambda x, y, g: fused_xent_fwd_reference(x, y), sets, n_iter)
        f_lib = device_ms(lambda x, y, g: F.cross_entropy(x, y, reduction="none"), lib_sets,
                          n_iter)
        b_ms = device_ms(fused_xent_bwd, sets, n_iter)
        b_plain = device_ms(fused_xent_bwd_reference, sets, n_iter)
        graphs = []
        for xi, yi, gi in lib_sets:
            xl = xi.detach().requires_grad_()
            graphs.append((F.cross_entropy(xl, yi, reduction="none"), xl, gi))
        b_lib = device_ms(lambda o, xl, gi: torch.autograd.grad(o, xl, gi, retain_graph=True),
                          graphs, n_iter)
        del graphs
        fb, fby = bound_ms(B * C * (xs + 4) + 4 * B, 5 * B * C)
        bb, bby = bound_ms(B * C * (2 * xs + 4) + 4 * B, 6 * B * C)
        route = {"route": ROUTES[plan[0]], "vec": plan[1], "cluster": plan[2],
                 "slice": plan[3], "launch": launch_shape(B, C, dtype, plan),
                 "sets": len(sets)}
        for kind, ms, plain, lib, bms, by, err in (
                ("fwd", f_ms, f_plain, f_lib, fb, fby, err_f),
                ("bwd", b_ms, b_plain, b_lib, bb, bby, err_b)):
            out[kind].append({"case": name, "shape": [B, C], "dtype": str(dtype), **route,
                              "max_abs_err": err, "same_bits": same, "ms": ms,
                              "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
                              "bound_by": by, "bound_share": bms / ms})
            if name == "main":
                rows[kind] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                              "bound_ms": bms, "bound_by": by, "floor_ms": floor}
        del sets, lib_sets, x, y, g, fwd, bwd
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernel": "fused_xent", "floor_ms": floor,
          "floor_grid": fit_grid, "fwd": out["fwd"], "bwd": out["bwd"], "card": card})
    lines = {"fwd": ("fused_xent_fwd", "elephas_tpu/ops/pallas_ops.py:99",
                     "F.cross_entropy(x, y, reduction='none'), probability targets"),
             "bwd": ("fused_xent_bwd", "elephas_tpu/ops/pallas_ops.py:113",
                     "autograd backward of that F.cross_entropy")}
    return [{"name": lines[k][0], "route": "cuda",
             "source": "elephas_tpu_torch/ops/csrc/fused_xent.cu", "replaces": lines[k][1],
             "max_abs_err": worst[k], **rows[k], "library": lines[k][2],
             "timed_shape": [1024, 10]} for k in ("fwd", "bwd")]


def _mlp_model(device="cuda", dropout=True, **kw):
    """``SparkModel`` over the committed JSON (dropout rates 0 unless
    ``dropout``), initialised from the config with the adapter's seed 0."""
    from elephas_tpu_torch import SparkModel

    cfg = json.load(open(MNIST_JSON))
    if not dropout:
        for layer in cfg["config"]["layers"]:
            if layer["class_name"] == "Dropout":
                layer["config"]["rate"] = 0.0
    return SparkModel(json.dumps(cfg), device=device, **kw)


def fit_mlp(card):
    """The MLP fit at its full configuration through ``SparkModel.fit``:
    exactly E*S K1-bwd launches and E*(S + Sv) K1-fwd launches (S training
    and Sv validation batches an epoch, every worker's batch in one
    launch), falling loss and rising accuracy; samples/s raw and marginal
    (4-epoch minus 1-epoch fits, bench.py:1767-1795); a profiled 1-epoch
    fit; then ``evaluate`` and ``predict`` on 2048 held-out samples."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = MLP_FIT
    t0 = time.perf_counter()
    (x, y), (xt, yt) = mnist_like(c["samples"], c["held_out"])
    # one partition per worker, as bench.py builds it: no repartition, so
    # every fit reuses the blocks and the data staged on the card
    rdd = to_simple_rdd(SparkContext(f"local[{c['workers']}]"), x, y,
                        num_slices=c["workers"])
    sm = _mlp_model(mode="synchronous", num_workers=c["workers"])
    setup_s = time.perf_counter() - t0
    fit = dict(batch_size=c["batch"], validation_split=c["validation_split"])
    E = c["epochs"]
    S, Sv = _mlp_steps(c["samples"], c["workers"], c["batch"], c["validation_split"])
    _zero_counters()
    t0 = time.perf_counter()
    sm.fit(rdd, epochs=E, **fit)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _read_counters()
    hist = sm.training_histories[-1]
    require(all(np.isfinite(v).all() for v in hist.values()), f"fit_mlp: non-finite {hist}")
    require(hist["loss"][-1] < hist["loss"][0], f"fit_mlp: loss did not fall: {hist['loss']}")
    require(hist["accuracy"][-1] > hist["accuracy"][0],
            f"fit_mlp: accuracy did not rise: {hist['accuracy']}")
    want = {"fused_xent_fwd": E * (S + Sv), "fused_xent_bwd": E * S}
    for name, n in want.items():
        require(counts[name] == n, f"fit_mlp: {name} launched {counts[name]} times, "
                                   f"want {n} (E {E}, S {S}, Sv {Sv})")
    others = {k: v for k, v in counts.items() if k not in want and v}
    require(not others, f"fit_mlp: other kernels launched: {others}")

    n_train = c["workers"] * (c["samples"] // c["workers"]
                              - int(c["samples"] // c["workers"] * c["validation_split"]))

    def best(epochs, reps=2):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            sm.fit(rdd, epochs=epochs, **fit)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return min(times), times

    t4, t4s = best(E)
    t1, t1s = best(1)
    marginal = n_train * (E - 1) / (t4 - t1) if t4 > t1 else None
    prof = profiled(lambda: sm.fit(rdd, epochs=1, **fit), 1, top_n=12)
    prof["steps_per_epoch"] = S
    engine_s = sm.timings[-1]["run_seconds"]

    loss, acc = sm.evaluate(xt, yt)
    pred = sm.predict(xt)
    require(pred.shape == (c["held_out"], 10) and bool(np.isfinite(pred).all()),
            f"fit_mlp: predict gave {pred.shape}")
    pred_acc = float((pred.argmax(1) == yt.argmax(1)).mean())
    require(np.isfinite(loss) and abs(pred_acc - acc) < 1e-6,
            f"fit_mlp: evaluate accuracy {acc} vs predict's {pred_acc}")
    require(acc > 0.5, f"fit_mlp: held-out accuracy {acc} (chance is 0.1)")
    emit({"phase": "fit_mlp", "config": MNIST_JSON, **c, "mode": "synchronous",
          "steps_per_epoch": S, "val_steps_per_epoch": Sv, "setup_s": setup_s,
          "first_fit_s": first_s, "history": hist, "launches": counts,
          "launches_want": want, "train_samples_per_epoch": n_train,
          "fit4_s": t4, "fit4_all_s": t4s, "fit1_s": t1, "fit1_all_s": t1s,
          "samples_per_s": n_train * E / t4, "marginal_samples_per_s": marginal,
          "ms_per_step": (t4 - t1) / ((E - 1) * S) * 1e3 if t4 > t1 else None,
          "profiled_fit_1_epoch": prof, "profiled_engine_s": engine_s,
          "held_out_eval": {"loss": loss, "accuracy": acc, "predict_accuracy": pred_acc},
          "card": card})
    return counts


def fit_matrix(card):
    """The five compiled-path schedules on the card at the MNIST MLP's
    widths (8192 samples, 2 workers, 2 epochs): finite, falling losses, and
    K1 launched in each (K1-bwd once per step; the gradient-synchronous
    schedule too, with one launch for every worker's batch). Two workers,
    because the asynchronous modes' default merge applies the SUM of the
    workers' deltas (the parameter server's semantics, as in the
    reference): eight workers' summed Adam epochs overshoot and the loss of
    this data rises in the reference's engine and in the port alike."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    (x, y), _ = mnist_like(8192, 0)
    W = 2
    rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x, y, num_slices=W)
    S, Sv = _mlp_steps(8192, W, 128, 0.1)
    res = []
    for mode, freq in [("synchronous", "epoch"), ("synchronous", "batch"),
                       ("asynchronous", "epoch"), ("asynchronous", "batch"),
                       ("hogwild", "epoch")]:
        sm = _mlp_model(mode=mode, frequency=freq, parameter_server_mode="jax",
                        num_workers=W)
        _zero_counters()
        t0 = time.perf_counter()
        sm.fit(rdd, epochs=2, batch_size=128, validation_split=0.1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counters()
        hist = sm.training_histories[-1]
        require(all(np.isfinite(v).all() for v in hist.values()),
                f"fit_matrix {mode}/{freq}: non-finite {hist}")
        require(hist["loss"][-1] < hist["loss"][0],
                f"fit_matrix {mode}/{freq}: loss did not fall: {hist['loss']}")
        require(counts["fused_xent_bwd"] == 2 * S and counts["fused_xent_fwd"] == 2 * (S + Sv),
                f"fit_matrix {mode}/{freq}: K1 launches {counts['fused_xent_fwd']}/"
                f"{counts['fused_xent_bwd']}, want {2 * (S + Sv)}/{2 * S}")
        res.append({"mode": mode, "frequency": freq, "history": hist, "wall_s": wall,
                    "k1_fwd": counts["fused_xent_fwd"], "k1_bwd": counts["fused_xent_bwd"]})
    emit({"phase": "fit_matrix", "samples": 8192, "workers": W, "epochs": 2,
          "batch": 128, "fits": res, "card": card})


def fit_cross_check(card):
    """One short fit (4096 samples, 4 workers, 2 epochs, dropout off) on
    the card and on ``device="cpu"`` from the same weights (the config's
    initializers, seed 0) and the same order (drawn on the host): the
    synchronous schedules' histories within rtol 1e-4 and every weight
    within 1e-4 of its array's largest entry (float32: cuBLAS and the CPU's
    BLAS sum in other orders, compounded over 58 steps)."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    (x, y), _ = mnist_like(4096, 0)
    checks = []
    for freq in ("epoch", "batch"):
        out = {}
        for dev in ("cuda", "cpu"):
            sm = _mlp_model(device=dev, dropout=False, mode="synchronous", frequency=freq,
                            num_workers=4)
            sm.fit(to_simple_rdd(SparkContext("local[4]"), x, y, num_slices=4), epochs=2,
                   batch_size=128, validation_split=0.1)
            out[dev] = (sm.training_histories[-1], sm.master_network.get_weights())
        hist_err = max(abs(a - b) / max(abs(b), 1e-6) for k in out["cpu"][0]
                       for a, b in zip(out["cuda"][0][k], out["cpu"][0][k]))
        w_err = max(float(np.abs(a - b).max()) / float(np.abs(b).max() or 1.0)
                    for a, b in zip(out["cuda"][1], out["cpu"][1]))
        require(hist_err <= 1e-4, f"fit_cross_check {freq}: histories differ by {hist_err} "
                                  f"(relative): {out['cuda'][0]} vs {out['cpu'][0]}")
        require(w_err <= 1e-4, f"fit_cross_check {freq}: weights differ by {w_err} of scale")
        checks.append({"frequency": freq, "history_rel_err": hist_err,
                       "weight_err_rel_to_scale": w_err, "tol": 1e-4,
                       "history_gpu": out["cuda"][0], "history_cpu": out["cpu"][0]})
    emit({"phase": "fit_cross_check", "samples": 4096, "workers": 4, "epochs": 2,
          "checks": checks, "card": card})


# -- phases 23 to 26: the host parameter-server path and checkpoints --------------

HOST_FIT = dict(samples=32768, held_out=2048, batch=128, workers=2, epochs=4,
                validation_split=0.1)


class _TimedClient:
    """A parameter client whose pulls and pushes are timed on the host's
    clock (round trips in ms, appended to ``times``); everything else
    passes through."""

    def __init__(self, inner, times):
        self._inner, self._times = inner, times

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _timed(self, kind, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        self._times.setdefault(kind, []).append((time.perf_counter() - t) * 1e3)
        return out

    def get_parameters(self):
        return self._timed("pull", self._inner.get_parameters)

    def _pickled(self, delta):
        """The push's own serialisation, timed apart (``push_pickle``): the
        client's ``pickle.dumps`` of the delta, done once more before the
        push itself."""
        import pickle

        from elephas_tpu_torch.parameter.client import _to_wire

        t = time.perf_counter()
        pickle.dumps(_to_wire(delta), protocol=pickle.HIGHEST_PROTOCOL)
        self._times.setdefault("push_pickle", []).append((time.perf_counter() - t) * 1e3)

    def update_parameters(self, delta):
        self._pickled(delta)
        return self._timed("push", self._inner.update_parameters, delta)

    def update_parameters_tagged(self, task_id, delta, attempt=None):
        self._pickled(delta)
        return self._timed("push", self._inner.update_parameters_tagged, task_id,
                           delta, attempt=attempt)


def _host_steps(n: int, workers: int, batch: int, split: float, frequency: str):
    """``(S, Sv)`` a worker and epoch on the host path: ``model.fit``'s
    batches (Keras's split ``floor(n (1 - split))``, the last partial batch
    trained) and validation batches for ``"epoch"``; whole batches of the
    reference's ``n - int(n split)`` rows and no validation for ``"batch"``."""
    import math

    per = n // workers
    if frequency == "batch":
        return (per - int(per * split)) // batch, 0
    n_train = math.floor(per * (1.0 - split))
    return -(-n_train // batch), -(-(per - n_train) // batch)


def _host_fit(what, sm, x, y, workers, epochs, batch, split, frequency, times=None):
    """One host-path fit with the launch counts set to 0 just before and read
    just after: ``(wall seconds, counts, histories)``, after checking exact K1
    counts, no other kernel, and finite, falling losses in every partition."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    if times is not None:
        make = sm._make_client
        sm._make_client = lambda: _TimedClient(make(), times)
    rdd = to_simple_rdd(SparkContext(f"local[{workers}]"), x, y, num_slices=workers)
    n_hist = len(sm.training_histories)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    sm.fit(rdd, epochs=epochs, batch_size=batch, validation_split=split)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    hists = sm.training_histories[n_hist:]
    S, Sv = _host_steps(len(x), workers, batch, split, frequency)
    want = {"fused_xent_fwd": workers * epochs * (S + Sv),
            "fused_xent_bwd": workers * epochs * S}
    for name, n in want.items():
        require(counts[name] == n, f"{what}: {name} launched {counts[name]} times, want "
                                   f"{n} (W {workers}, E {epochs}, S {S}, Sv {Sv})")
    others = {k: v for k, v in counts.items() if k not in want and v}
    require(not others, f"{what}: other kernels launched: {others}")
    require(len(hists) == workers, f"{what}: {len(hists)} histories for {workers} workers")
    for h in hists:
        require(all(np.isfinite(v).all() for v in h.values()), f"{what}: non-finite {h}")
        require(h["loss"][-1] < h["loss"][0], f"{what}: loss did not fall: {h['loss']}")
    return wall, counts, hists, want


def _host_scaling(x, y):
    """Whether the worker threads overlap: the reference's defaults at W 1
    and W 2, each worker holding ``fit_host``'s partition (16384 rows), 2
    epochs, the counts checked as in ``fit_host``. A worker's ms a training
    step is the fit's wall over E S: the same at W 1 and W 2 where the
    threads run side by side, twice at W 2 where they take turns. With the
    pull, push and push-pickle medians of each."""
    c = HOST_FIT
    per, E, B, split = c["samples"] // c["workers"], 2, c["batch"], c["validation_split"]
    out = []
    for w in (1, 2):
        times = {}
        sm = _mlp_model(num_workers=w, port=0)
        wall, _, _, _ = _host_fit(f"fit_host W={w}", sm, x[:w * per], y[:w * per], w, E,
                                  B, split, "epoch", times)
        S, Sv = _host_steps(w * per, w, B, split, "epoch")
        out.append({"workers": w, "samples": w * per, "epochs": E, "wall_s": wall,
                    "steps_per_epoch": S, "val_steps_per_epoch": Sv,
                    "worker_ms_per_step": wall * 1e3 / (E * S),
                    "samples_per_s": w * int(np.floor(per * (1.0 - split))) * E / wall,
                    **{f"{k}_ms_median": float(np.median(v)) for k, v in times.items()}})
    return out


def fit_host(card):
    """The reference's defaults on the committed MLP JSON at full width:
    ``SparkModel(json)`` with no mode arguments (asynchronous, ``"http"``,
    ``frequency="epoch"``, dropout on), 2 workers (threads), 32768 samples,
    batch 128, 4 epochs, ``validation_split=0.1``. Exactly sum over workers
    of E (S_w + Sv_w) K1-fwd and E S_w K1-bwd launches, no other kernel;
    falling losses; held-out accuracy over 0.5; the server's pushes and
    pulls those of the schedule (one each a worker and epoch, and the
    final pull of the fit); samples/s, the median and summed pull and push
    round trips, the push's pickling apart, a profiled 1-epoch fit, and
    :func:`_host_scaling`."""
    c = HOST_FIT
    (x, y), (xt, yt) = mnist_like(c["samples"], c["held_out"])
    sm = _mlp_model(num_workers=c["workers"], port=0)
    require((sm.mode, sm.parameter_server_mode, sm.comm, sm.frequency) ==
            ("asynchronous", "http", "host", "epoch"), "fit_host: not the reference defaults")
    times = {}
    wall, counts, hists, want = _host_fit(
        "fit_host", sm, x, y, c["workers"], c["epochs"], c["batch"],
        c["validation_split"], "epoch", times)
    ps = sm.membership_snapshot()["parameter_servers"]["primary"]
    W, E = c["workers"], c["epochs"]
    require(ps["version"] == W * E and ps["pulls"] == W * E + 1,
            f"fit_host: server saw {ps['version']} pushes and {ps['pulls']} pulls, "
            f"want {W * E} and {W * E + 1}")
    require(len(times.get("push", [])) == W * E, f"fit_host: timed pushes {times}")
    loss, acc = sm.evaluate(xt, yt)
    require(np.isfinite(loss) and acc > 0.5, f"fit_host: held-out accuracy {acc}")
    pull_ms, push_ms = list(times["pull"]), list(times["push"])
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x, y, num_slices=W)
    prof = profiled(lambda: sm.fit(rdd, epochs=1, batch_size=c["batch"],
                                   validation_split=c["validation_split"]), 1, top_n=10)
    S, Sv = _host_steps(c["samples"], W, c["batch"], c["validation_split"], "epoch")
    n_train = W * int(np.floor(c["samples"] // W * (1.0 - c["validation_split"])))
    emit({"phase": "fit_host", "config": MNIST_JSON, **c, "mode": sm.mode,
          "parameter_server_mode": sm.parameter_server_mode, "frequency": sm.frequency,
          "steps_per_epoch": S, "val_steps_per_epoch": Sv, "wall_s": wall,
          "histories": hists, "launches": counts, "launches_want": want,
          "k1_launches_per_step": {"fused_xent_fwd": counts["fused_xent_fwd"] / (W * E * S),
                                   "fused_xent_bwd": counts["fused_xent_bwd"] / (W * E * S)},
          "server": ps, "train_samples_per_epoch": n_train,
          "samples_per_s": n_train * E / wall,
          "pull_ms_median": float(np.median(pull_ms)),
          "push_ms_median": float(np.median(push_ms)),
          "pull_ms_sum": float(np.sum(pull_ms)), "push_ms_sum": float(np.sum(push_ms)),
          "push_pickle_ms_median": float(np.median(times["push_pickle"])),
          "pulls_timed": len(pull_ms), "pushes_timed": len(push_ms),
          "profiled_fit_1_epoch": prof, "thread_scaling": _host_scaling(x, y),
          "held_out_eval": {"loss": loss, "accuracy": acc}, "card": card})
    return counts


def fit_host_matrix(card):
    """Six host-path cells at the MLP's widths (8192 samples, 2 workers, 2
    epochs, batch 128): asynchronous http batch, asynchronous socket epoch,
    hogwild socket batch, hogwild native epoch (the unchanged
    ``native/ps_server.cpp`` built here by ``make``; a failed build fails
    the phase), synchronous ``comm="host"``, asynchronous http epoch with
    int8 compression. Each: exact K1 counts from the worker threads, no
    other kernel, finite and falling losses. Then a K1 error injected in a
    worker fails the fit after the RDD's task retries."""
    (x, y), _ = mnist_like(8192, 0)
    W, E, B, split = 2, 2, 128, 0.1
    res = []
    for kw in [dict(mode="asynchronous", parameter_server_mode="http", frequency="batch"),
               dict(mode="asynchronous", parameter_server_mode="socket", frequency="epoch"),
               dict(mode="hogwild", parameter_server_mode="socket", frequency="batch"),
               dict(mode="hogwild", parameter_server_mode="native", frequency="epoch"),
               dict(mode="synchronous", comm="host", frequency="epoch"),
               dict(mode="asynchronous", parameter_server_mode="http", frequency="epoch",
                    compression="int8")]:
        what = "fit_host_matrix " + "/".join(str(v) for v in kw.values())
        sm = _mlp_model(num_workers=W, port=0, **kw)
        wall, counts, hists, _ = _host_fit(what, sm, x, y, W, E, B, split, kw["frequency"])
        res.append({**kw, "wall_s": wall, "histories": hists,
                    "k1_fwd": counts["fused_xent_fwd"], "k1_bwd": counts["fused_xent_bwd"],
                    "server": sm.membership_snapshot()["parameter_servers"]})
    emit({"phase": "fit_host_matrix", "samples": 8192, "workers": W, "epochs": E,
          "batch": B, "fits": res, "kernel_error": _host_kernel_error(x, y), "card": card})


def _host_kernel_error(x, y):
    """A K1 launch that fails in a worker (its C entry's error, injected):
    every task attempt raises, the fit fails with ``TaskFailedError`` after
    ``maxTaskFailures`` attempts, and the server is stopped."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.data.rdd import TaskFailedError
    from elephas_tpu_torch.ops import fused_xent
    from elephas_tpu_torch.utils import to_simple_rdd

    attempts = []

    def failing(entry, *args, **kw):
        attempts.append(entry)
        raise RuntimeError(f"{entry}: CUDA error 700 (an illegal memory access, injected)")

    sm = _mlp_model(num_workers=1, port=0)
    sc = SparkContext("local[1]")
    launch, fused_xent._launch = fused_xent._launch, failing
    try:
        sm.fit(to_simple_rdd(sc, x[:1024], y[:1024], num_slices=1), epochs=1,
               batch_size=128)
        err = None
    except TaskFailedError as e:
        err = e
    finally:
        fused_xent._launch = launch
    require(err is not None and len(attempts) == sc.maxTaskFailures and sm._server is None,
            f"fit_host_matrix: an injected K1 error gave {err!r} after {len(attempts)} "
            f"attempts (want TaskFailedError after {sc.maxTaskFailures}), server "
            f"{sm._server}")
    return {"error": repr(err)[:200], "attempts": len(attempts),
            "max_task_failures": sc.maxTaskFailures}


def fit_host_cross_check(card):
    """One worker, ``shuffle=False``, dropout off, 4096 samples, 2 epochs:
    the host path on the card and on ``device="cpu"`` from the same weights
    and the same seeded ``np.random`` orders (the asynchronous epoch worker
    shuffles as the reference's does): http/epoch and socket/batch.
    Histories within rtol 1e-4 and weights within 1e-4 of their array's
    scale, as ``fit_cross_check`` pins the compiled path."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    (x, y), _ = mnist_like(4096, 0)
    checks = []
    for ps_mode, freq in (("http", "epoch"), ("socket", "batch")):
        out = {}
        for dev in ("cuda", "cpu"):
            sm = _mlp_model(device=dev, dropout=False, parameter_server_mode=ps_mode,
                            frequency=freq, num_workers=1, port=0)
            np.random.seed(SEED)
            sm.fit(to_simple_rdd(SparkContext("local[1]"), x, y, num_slices=1), epochs=2,
                   batch_size=128, validation_split=0.1, shuffle=False)
            out[dev] = (sm.training_histories[-1], sm.master_network.get_weights())
        hist_err = max(abs(a - b) / max(abs(b), 1e-6) for k in out["cpu"][0]
                       for a, b in zip(out["cuda"][0][k], out["cpu"][0][k]))
        w_errs = [float(np.abs(a - b).max()) / float(np.abs(b).max() or 1.0)
                  for a, b in zip(out["cuda"][1], out["cpu"][1])]
        w_err = max(w_errs)
        require(hist_err <= 1e-4, f"fit_host_cross_check {ps_mode}/{freq}: histories "
                                  f"differ by {hist_err}: {out['cuda'][0]} vs {out['cpu'][0]}")
        if w_err > 1e-4:
            i = int(np.argmax(w_errs))
            a, b = out["cuda"][1][i], out["cpu"][1][i]
            d = np.abs(a - b)
            j = np.unravel_index(d.argmax(), d.shape)
            require(False, f"fit_host_cross_check {ps_mode}/{freq}: weights differ by "
                           f"{w_err} of scale: array {i} {a.shape}, "
                           f"{int((d > 1e-4 * np.abs(b).max()).sum())} elements over the "
                           f"pin, the worst at {j}: {a[j]} (card) vs {b[j]} (CPU); "
                           f"per array {w_errs}")
        checks.append({"parameter_server_mode": ps_mode, "frequency": freq,
                       "history_rel_err": hist_err, "weight_err_rel_to_scale": w_err,
                       "tol": 1e-4, "history_gpu": out["cuda"][0],
                       "history_cpu": out["cpu"][0]})
    emit({"phase": "fit_host_cross_check", "samples": 4096, "workers": 1, "epochs": 2,
          "checks": checks, "card": card})


def checkpoint_phase(card):
    """A synchronous 4-epoch fit (compiled path, dropout on, 8192 samples, 4
    workers) against a 2-epoch checkpointed fit resumed by a new
    ``SparkModel`` to 4 epochs: weights and histories within the reference
    test's rtol 1e-5 / atol 1e-6; then ``save`` → ``load_spark_model`` →
    ``predict`` gives the same bits."""
    import tempfile

    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.spark_model import load_spark_model
    from elephas_tpu_torch.utils import to_simple_rdd

    (x, y), (xt, _) = mnist_like(8192, 512)
    fit = dict(batch_size=128, validation_split=0.1)
    rdd = to_simple_rdd(SparkContext("local[4]"), x, y, num_slices=4)
    with tempfile.TemporaryDirectory() as d:
        plain = _mlp_model(mode="synchronous", num_workers=4)
        t0 = time.perf_counter()
        plain.fit(rdd, epochs=4, **fit)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        first = _mlp_model(mode="synchronous", num_workers=4)
        first.fit(rdd, epochs=2, checkpoint_dir=d, checkpoint_frequency=2, **fit)
        second = _mlp_model(mode="synchronous", num_workers=4)
        t0 = time.perf_counter()
        second.fit(rdd, epochs=4, checkpoint_dir=d, checkpoint_frequency=2, resume=True,
                   **fit)
        torch.cuda.synchronize()
        resumed_s = time.perf_counter() - t0
        errs = [float(np.abs(a - b).max()) for a, b in
                zip(second.master_network.get_weights(), plain.master_network.get_weights())]
        for a, b in zip(second.master_network.get_weights(),
                        plain.master_network.get_weights()):
            require(np.allclose(a, b, rtol=1e-5, atol=1e-6),
                    f"checkpoint: resumed weights off by {np.abs(a - b).max()}")
        hist = first.training_histories[-1]["loss"] + second.training_histories[-1]["loss"]
        require(np.allclose(hist, plain.training_histories[-1]["loss"], rtol=1e-5, atol=1e-6),
                f"checkpoint: losses {hist} vs {plain.training_histories[-1]['loss']}")
        path = f"{d}/model.npz"
        second.save(path)
        loaded = load_spark_model(path)
        same = bool(np.array_equal(loaded.predict(xt), second.predict(xt)))
        require(same, "checkpoint: load_spark_model predicts other bits than the saved model")
    emit({"phase": "checkpoint", "samples": 8192, "workers": 4, "epochs": 4,
          "resumed_at_epoch": 2, "weight_abs_err": errs, "rtol": 1e-5, "atol": 1e-6,
          "losses_plain": plain.training_histories[-1]["loss"], "losses_chunked": hist,
          "plain_fit_s": plain_s, "resumed_fit_s": resumed_s,
          "save_load_predict_same_bits": same, "card": card})


# -- phases 27 and 28: rotary-LM training at Llama-3-8B width ---------------------

# Meta-Llama-3-8B's published config.json widths (the repo's `llama` family,
# models/hf_import.py: swiglu, rmsnorm, rotary, GQA); depth is the only cut
# (32 layers of parameters, gradients and Adam moments in float32 pass 80 GB)
LLAMA3_8B = dict(vocab=128256, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
                 max_len=8192, activation="swiglu", ffn_bias=False, norm="rmsnorm",
                 norm_eps=1e-5, pos_encoding="rotary", rope_theta=LLAMA_THETA,
                 attn_bias=False, tie_embeddings=False)
LLAMA_TRAIN_LAYERS = 4
ROPE_ROWS = ("flash_attention_rope_fwd", "flash_attention_rope_dq",
             "flash_attention_rope_dkv")
PLAIN_K2_ROWS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")


def _llama_steps(step, params, state, batch, n_steps):
    """``n_steps`` steps; ``(params, state, losses, wall seconds, launch
    counts)`` with the counts set to 0 just before and read just after."""
    torch.cuda.synchronize()
    _zero_counters()
    losses = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        params, state, loss = step(params, state, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return params, state, [float(x) for x in losses], wall, _read_counters()


def _want_rope_launches(what, counts, L, n_steps):
    for name in ROPE_ROWS + PLAIN_K2_ROWS + ("layer_norm_fwd",):
        per_step = L if name in ROPE_ROWS else 0
        require(counts[name] == per_step * n_steps,
                f"{what}: {name} launched {counts[name]} times in {n_steps} steps, "
                f"want {per_step} per step")


def train_llama(card):
    """Llama-3-8B widths, 4 of 32 layers, float32, random weights drawn on
    the card, trained by ``build_lm_train_step(model, None,
    adam_compact(1e-3), attn="flash")`` on one fixed batch of 4 x 2048
    tokens: 2 warm-up and 3 timed steps with finite, falling losses and per
    step exactly L launches of each rope-on-load flash-attention kernel and
    none of the plain ones; a profiled step; then ``train_llama_bf16``: 2
    steps from the same initial weights with ``compute_dtype="bfloat16"``."""
    from elephas_tpu_torch.models import (TransformerLM, adam_compact,
                                          build_lm_train_step, make_lm_batches)

    L = LLAMA_TRAIN_LAYERS
    model = TransformerLM(**dict(LLAMA3_8B, n_layers=L), device="cuda")
    params = draw_params(model, SEED + 31)
    B, T = 4, 2048
    rows = np.random.default_rng(SEED + 32).integers(0, LLAMA3_8B["vocab"],
                                                     size=(B, T + 1))
    batch = tuple(torch.from_numpy(a).cuda() for a in make_lm_batches(rows))
    step, opt_init = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")
    state = opt_init(params)
    params, state, warm, _, _ = _llama_steps(step, params, state, batch, 2)
    torch.cuda.reset_peak_memory_stats()
    n_steps = 3
    params, state, timed, wall, counts = _llama_steps(step, params, state, batch, n_steps)
    peak = torch.cuda.max_memory_allocated()
    losses = warm + timed
    require(all(np.isfinite(losses)), f"train_llama: non-finite loss in {losses}")
    require(losses[-1] < losses[0], f"train_llama: loss did not fall: {losses}")
    _want_rope_launches("train_llama", counts, L, n_steps)
    prof = profiled(lambda: step(params, state, *batch), 1, top_n=16)
    del state
    emit({"phase": "train_llama", "model": f"Llama-3-8B widths, {L} of 32 layers "
          "(random weights, seed 31)", "dtype": "float32",
          "optimizer": "adam_compact(1e-3)", "attn": "flash", "batch": B, "seq_len": T,
          "warmup_steps": 2, "timed_steps": n_steps, "ms_per_step": wall * 1e3 / n_steps,
          "tokens_per_s": n_steps * B * T / wall, "peak_mem_gb": peak / 1e9,
          "losses": losses, "launches": counts,
          "launches_per_step": {k: v / n_steps for k, v in counts.items()},
          "profiled_step": prof, "card": card})
    summary = {"ms_per_step": wall * 1e3 / n_steps, "tokens_per_s": n_steps * B * T / wall,
               "peak_mem_gb": peak / 1e9, "first_loss": losses[0]}

    # bf16 compute from the same initial weights (float32 master weights,
    # fresh moments): its first loss is the float32 run's first loss to
    # bf16 rounding (1e-2 relative), and the next one is lower
    model16 = TransformerLM(**dict(LLAMA3_8B, n_layers=L), compute_dtype="bfloat16",
                            device="cuda")
    step16, opt_init16 = build_lm_train_step(model16, None, adam_compact(1e-3),
                                             attn="flash")
    p16 = draw_params(model16, SEED + 31)
    torch.cuda.reset_peak_memory_stats()
    p16, _, losses16, wall16, counts16 = _llama_steps(step16, p16, opt_init16(p16),
                                                      batch, 2)
    peak16 = torch.cuda.max_memory_allocated()
    del p16
    rel16 = abs(losses16[0] - losses[0]) / abs(losses[0])
    require(all(np.isfinite(losses16)), f"train_llama bf16: non-finite loss in {losses16}")
    require(rel16 <= 1e-2, f"train_llama bf16: first loss {losses16[0]} vs float32 "
                           f"{losses[0]} (relative {rel16} > 1e-2)")
    require(losses16[-1] < losses16[0], f"train_llama bf16: loss did not fall: {losses16}")
    _want_rope_launches("train_llama bf16", counts16, L, 2)
    emit({"phase": "train_llama_bf16", "model": "the same, compute_dtype='bfloat16'",
          "steps": 2, "losses": losses16, "float32_first_loss": losses[0],
          "first_loss_rel_diff": rel16, "first_loss_rtol": 1e-2,
          "ms_per_step": wall16 * 1e3 / 2, "peak_mem_gb": peak16 / 1e9,
          "launches": {k: counts16[k] for k in ROPE_ROWS + PLAIN_K2_ROWS}, "card": card})
    return params, counts, summary


def train_llama_cross_check(card, params):
    """One layer at full width, B 1, T 64: the loss and every gradient on
    the card against ``device="cpu"`` from the same weights, at
    ``train_cross_check``'s tolerances (loss rtol 1e-4; each gradient within
    1e-3 of its scale, floored at 1e-4 of the largest entry)."""
    from elephas_tpu_torch.models import (TransformerLM, adam_compact,
                                          build_lm_train_step, make_lm_batches)

    rows = np.random.default_rng(SEED + 33).integers(0, LLAMA3_8B["vocab"],
                                                     size=(1, 65))
    batch = make_lm_batches(rows)
    out = {}
    for dev in ("cuda", "cpu"):
        model = TransformerLM(**dict(LLAMA3_8B, n_layers=1), device=dev)
        p = _layer_slice(model, params, dev)
        step, _ = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")
        _zero_counters()
        loss, grads = step.grad(p, *batch)
        if dev == "cuda":
            _want_rope_launches("train_llama_cross_check", _read_counters(), 1, 1)
        out[dev] = (float(loss), {k: g.cpu() for k, g in grads.items()})
        del p, grads
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    require(loss_rel <= 1e-4, f"train_llama_cross_check: loss {lg} vs cpu {lc}")
    floor = 1e-4 * max(float(g.abs().max()) for g in gc.values())
    grad_rel = {k: float((gg[k].double() - gc[k].double()).abs().max())
                / max(float(gc[k].abs().max()), floor) for k in gc}
    worst = max(grad_rel, key=grad_rel.get)
    require(grad_rel[worst] <= 1e-3, f"train_llama_cross_check: gradient of {worst} "
                                     f"off by {grad_rel[worst]} of its scale")
    emit({"phase": "train_llama_cross_check", "layers": 1, "batch": 1, "seq_len": 64,
          "loss_gpu": lg, "loss_cpu": lc, "loss_rel_diff": loss_rel, "loss_rtol": 1e-4,
          "grad_err_rel_to_scale": grad_rel, "scale_floor": floor, "grad_tol": 1e-3,
          "card": card})


# -- phases 28h to 28l: LoRA and multi-tenant serving at Llama-3-8B width ---------

MT_LAYERS = 4
MT_ADAPTERS = 8
MT_RANK = 16
MT_TARGETS = ("q", "k", "v", "o")
MT_MAX_LEN = 512               # the serve mix's 256 + 32 fits; 32 pages of 16 a slot
MT_NEW = 32
LORA_KEYS = ("wq", "wv")
LORA_RANK = 16


def _multi_tenant():
    """A ``MultiTenantLM`` at Llama-3-8B's widths, 4 of 32 layers, 8 adapters
    of rank 16 on q, k, v and o: the base weights drawn on the card, every
    ``A`` ~ N(0, 1/r) from the same generator, every ``B`` 0, then adapters
    1-7 given random ``B`` by ``randomize_adapter`` (the reference's draws)."""
    from elephas_tpu_torch.models import MultiTenantLM

    mt = MultiTenantLM(**dict(LLAMA3_8B, n_layers=MT_LAYERS), n_adapters=MT_ADAPTERS,
                       lora_rank=MT_RANK, lora_targets=MT_TARGETS, device="cuda")
    params = draw_params(mt, SEED + 51)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 52)
    for t in MT_TARGETS:
        a = params[f"lora_w{t}_a"]
        a.normal_(0.0, 1.0, generator=gen).div_(MT_RANK ** 0.5)
        params[f"lora_w{t}_b"].zero_()
    for aid in range(1, MT_ADAPTERS):
        params = mt.randomize_adapter(params, aid, seed=SEED + 53)
    return mt, params


def _llama_prompts():
    """The ``serve`` mix's 16 prompt lengths (32-256, the same draws) over
    Llama-3's vocabulary."""
    gen = np.random.default_rng(SEED + 2)
    return [gen.integers(0, LLAMA3_8B["vocab"], size=int(n)).astype(np.int32)
            for n in gen.integers(32, 257, size=16)]


def _tenant_run(model, params, prompts, adapter_ids, **kw):
    """One counted paged run (8 slots, pages of 16, ``MT_MAX_LEN``), request
    ``i`` on ``adapter_ids[i]``: ``(finished, wall, counts, engine)``."""
    from elephas_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, params, n_slots=8, paged=True, page_size=16,
                        max_len=MT_MAX_LEN, device="cuda", **kw)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    ids = [eng.submit(p, MT_NEW, adapter_id=a) for p, a in zip(prompts, adapter_ids)]
    fin = eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    require(len(fin) == len(ids), f"{len(fin)} of {len(ids)} requests finished")
    for rid in ids:
        require(fin[rid].finish_reason == "length" and len(fin[rid].tokens) == MT_NEW,
                f"{rid}: {fin[rid].finish_reason}, {len(fin[rid].tokens)} tokens")
    eng.kv.check()
    return [fin[r] for r in ids], wall, counts, eng


def _tenant_profile(model, params, prompts, adapter_ids):
    """Ten decode steps of a full 8-slot batch (request ``i`` on
    ``adapter_ids[i]``) under ``torch.profiler``."""
    from elephas_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, params, n_slots=8, paged=True, page_size=16,
                        max_len=MT_MAX_LEN, device="cuda")
    for p, a in zip(prompts[:8], adapter_ids[:8]):
        eng.submit(p, MT_NEW, adapter_id=a)
    while eng.scheduler.queue_depth:
        eng.step()

    def run():
        require(eng.step() == "decode", "serve_multi_tenant: the profiled window left "
                                        "the decode loop")

    return profiled(run, 10, top_n=8)


def _tenant_agree(what, mt, params, prompts, adapter_ids, got, want):
    """``_agree`` request by request, the near ties read off each tenant's
    merged weights (one tenant's merge on the card at a time)."""
    base = mt.base_model()
    compared = [0] * len(prompts)
    for aid in sorted(set(adapter_ids)):
        rows = [i for i, a in enumerate(adapter_ids) if a == aid]
        merged = mt.merged_params(params, aid)
        n = _agree(f"{what} adapter {aid}", base, merged, [prompts[i] for i in rows],
                   [got[i] for i in rows], [want[i] for i in rows])
        for i, c in zip(rows, n):
            compared[i] = c
        del merged
    return compared


def serve_multi_tenant(card):
    """The ``serve`` mix at Llama-3-8B widths behind the paged engine, request
    ``i`` on adapter ``i % 8``: exactly L K5-decode launches a decode step, L
    K5-chunk an insert and no K4; adapter 0 equal to the base model on the
    same engine token for token; each tenant equal to a dense engine on its
    merged weights up to near ties; some tenant differs from the base;
    ``kv.check()``; ms a step and tok/s beside the base model's on the same
    engine, the two models in turns (the host's share of a step moves from
    run to run)."""
    from elephas_tpu_torch.serving import ServingEngine

    torch.cuda.reset_peak_memory_stats()
    mt, params = _multi_tenant()
    base = mt.base_model()
    basep = {k: v for k, v in params.items() if not k.startswith("lora_")}
    prompts = _llama_prompts()
    aids = [i % MT_ADAPTERS for i in range(len(prompts))]
    _tenant_run(mt, params, [p[:32] for p in prompts[:2]], [1, 2])          # warm-up
    _tenant_run(base, basep, [p[:32] for p in prompts[:2]], [0, 0])
    fin, wall, counts, eng = _tenant_run(mt, params, prompts, aids)
    snap = eng.snapshot()
    steps, inserts = snap["engine"]["decode_steps"], snap["engine"]["prefills"]
    L = MT_LAYERS
    want = {"paged_flash_decode_lse": L * steps, "paged_flash_chunk": L * inserts}
    for name, n in counts.items():
        require(n == want.get(name, 0), f"serve_multi_tenant: {name} launched {n} times, "
                                        f"want {want.get(name, 0)} ({steps} decode steps, "
                                        f"{inserts} inserts)")
    tokens = [f.tokens for f in fin]
    stats = _serving_stats(snap, fin, wall)
    bfin, bwall, bcounts, beng = _tenant_run(base, basep, prompts, [0] * len(prompts))
    base_tokens = [f.tokens for f in bfin]
    base_stats = _serving_stats(beng.snapshot(), bfin, bwall)
    for i, a in enumerate(aids):
        if a == 0:
            require(tokens[i] == base_tokens[i],
                    f"serve_multi_tenant: request {i} on adapter 0 differs from the base "
                    f"model: {tokens[i]} vs {base_tokens[i]}")
    differ = [i for i, a in enumerate(aids) if a and tokens[i] != base_tokens[i]]
    require(differ, "serve_multi_tenant: every tenant's stream equals the base's")
    dense = []
    for aid in range(MT_ADAPTERS):
        rows = [i for i, a in enumerate(aids) if a == aid]
        merged = mt.merged_params(params, aid)
        e = ServingEngine(base, merged, n_slots=8, max_len=MT_MAX_LEN, device="cuda")
        ids = [e.submit(prompts[i], MT_NEW) for i in rows]
        got = e.drain()
        dense += [(i, got[r].tokens) for i, r in zip(rows, ids)]
        del merged, e
    dense = [t for _, t in sorted(dense)]
    compared = _tenant_agree("serve_multi_tenant vs merged dense", mt, params, prompts,
                             aids, tokens, dense)
    turns = []
    for tenants in (True, False, False, True, True, False):
        f, w, _, e = (_tenant_run(mt, params, prompts, aids) if tenants else
                      _tenant_run(base, basep, prompts, [0] * len(prompts)))
        st = _serving_stats(e.snapshot(), f, w)
        turns.append({"model": "multi_tenant" if tenants else "base",
                      **{k: st[k] for k in ("decode_ms_per_step_p50", "tok_per_s",
                                            "ttft_p50_s")}})
    mean = {m: {k: float(np.mean([t[k] for t in turns if t["model"] == m]))
                for k in ("decode_ms_per_step_p50", "tok_per_s")}
            for m in ("multi_tenant", "base")}
    prof = {"multi_tenant": _tenant_profile(mt, params, prompts, aids),
            "base": _tenant_profile(base, basep, prompts, [0] * len(prompts))}
    emit({"phase": "serve_multi_tenant", "model": f"Llama-3-8B widths, {L} of 32 layers "
          "(random weights, seed 51)", "adapters": MT_ADAPTERS, "lora_rank": MT_RANK,
          "lora_targets": list(MT_TARGETS), "page_size": 16, "max_len": MT_MAX_LEN,
          "requests": len(prompts), "new_tokens_each": MT_NEW,
          "prompt_lens": [int(len(p)) for p in prompts], "adapter_ids": aids,
          "decode_steps": steps, "inserts": inserts, "launches": counts,
          "launches_per_decode_step": {"paged_flash_decode_lse":
                                       counts["paged_flash_decode_lse"] / steps},
          "launches_per_insert": {"paged_flash_chunk": counts["paged_flash_chunk"] / inserts},
          **stats, "base_model_same_engine": base_stats, "in_turns": turns,
          "in_turns_mean": mean,
          "adapter_overhead_ms_per_step": (mean["multi_tenant"]["decode_ms_per_step_p50"]
                                           / mean["base"]["decode_ms_per_step_p50"]),
          "adapter_overhead_tok_per_s": (mean["multi_tenant"]["tok_per_s"]
                                         / mean["base"]["tok_per_s"]),
          "profiled_decode": prof,
          "adapter0_equals_base_bitwise": True, "tenants_differing_from_base": differ,
          "tokens_compared_with_merged_dense": compared, "memory": snap["memory"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card})
    return mt, params, prompts, tokens, counts, stats


def multi_tenant_prefix(card, mt, params):
    """One 192-token prefix with distinct suffixes (16-64 tokens, 32 new
    each), eight requests alternating adapters 1 and 2: a request adopts its
    own adapter's prefix pages and never the other's; the adopted count
    equals a ``device="cpu"`` engine's on the same mix; cache on against off,
    tokens up to near ties on each tenant's merged weights."""
    from elephas_tpu_torch.models import MultiTenantLM
    from elephas_tpu_torch.serving import ServingEngine

    gen = np.random.default_rng(SEED + 54)
    V = LLAMA3_8B["vocab"]
    shared = gen.integers(0, V, size=192).astype(np.int32)
    prompts = [np.concatenate([shared, gen.integers(0, V, size=int(n)).astype(np.int32)])
               for n in gen.integers(16, 65, size=8)]
    aids = [1 + i % 2 for i in range(len(prompts))]
    runs = {}
    for cache_on in (True, False):
        fin, wall, counts, eng = _tenant_run(mt, params, prompts, aids,
                                             prefix_cache=cache_on)
        runs[cache_on] = (fin, wall, counts, eng.snapshot(), eng)
    kv = runs[True][4].kv
    roots = {aid: {n.lid for n in _tree_nodes(kv.prefix._roots.get((0, aid), {}))}
             for aid in (1, 2)}
    require(roots[1] and roots[2] and not roots[1] & roots[2],
            f"multi_tenant_prefix: prefix pages by adapter {roots}")
    per_adapter = 192 // 16                       # the shared pages a later request adopts
    want_hits = sum(per_adapter * (aids.count(a) - 1) for a in (1, 2))
    on, off = runs[True][3]["memory"]["prefix"], runs[False][3]["memory"]["prefix"]
    require(on["hits_pages"] == want_hits and off["hits_pages"] == 0,
            f"multi_tenant_prefix: {on['hits_pages']} pages adopted (want {want_hits}), "
            f"{off['hits_pages']} with the cache off")
    # the page bookkeeping reads no weights: the CPU engine runs the same mix
    # at Llama-3's vocabulary on a one-layer, 64-wide multi-tenant model
    cpu_mt = MultiTenantLM(vocab=V, d_model=64, n_heads=4, n_layers=1, d_ff=128,
                           max_len=MT_MAX_LEN, n_adapters=MT_ADAPTERS, device="cpu")
    cpu = ServingEngine(cpu_mt, cpu_mt.init(SEED), n_slots=8, paged=True, page_size=16,
                        max_len=MT_MAX_LEN, device="cpu")
    for p, a in zip(prompts, aids):
        cpu.submit(p, MT_NEW, adapter_id=a)
    cpu.drain()
    cpu_hits = cpu.kv.memory_stats()["prefix"]["hits_pages"]
    require(on["hits_pages"] == cpu_hits,
            f"multi_tenant_prefix: {on['hits_pages']} pages adopted on the card, "
            f"{cpu_hits} on the CPU")
    compared = _tenant_agree("multi_tenant_prefix on vs off", mt, params, prompts, aids,
                             [f.tokens for f in runs[True][0]],
                             [f.tokens for f in runs[False][0]])
    emit({"phase": "multi_tenant_prefix", "shared_prefix": 192, "requests": len(prompts),
          "adapter_ids": aids, "new_tokens_each": MT_NEW,
          "suffix_lens": [int(len(p)) - 192 for p in prompts],
          "hits_pages": on["hits_pages"], "want_hits_pages": want_hits,
          "cpu_hits_pages": cpu_hits, "lookups_pages": on["lookups_pages"],
          "prefix_pages_by_adapter": {str(a): len(v) for a, v in roots.items()},
          "launches": runs[True][2],
          "cache_on": _serving_stats(runs[True][3], runs[True][0], runs[True][1]),
          "cache_off": _serving_stats(runs[False][3], runs[False][0], runs[False][1]),
          "tokens_compared": compared, "card": card})
    return runs[True][2]


def _tree_nodes(children):
    stack = list(children.values())
    while stack:
        node = stack.pop()
        yield node
        stack.extend(node.children.values())


def serve_multi_tenant_spec(card, mt, params, prompts, mt_tokens, mt_stats):
    """``serve_multi_tenant``'s mix at ``speculate_k=4`` with
    ``ModelDrafter(mt, params)``: a self-draft that drafts each row under its
    adapter. Greedy acceptance 100%; exact launches (the drafter's K4 L a
    draft step, K5-chunk L an insert and a verify round, K5-decode L a
    sequential step); streams equal ``serve_multi_tenant``'s up to near
    ties; ``kv.check()``."""
    from elephas_tpu_torch.serving import ModelDrafter

    aids = [i % MT_ADAPTERS for i in range(len(prompts))]
    _spec_run(mt, params, [p[:32] for p in prompts[:2]], 8, ModelDrafter(mt, params),
              paged=True, adapter_ids=[1, 2], max_len=MT_MAX_LEN)          # warm-up
    eng, tokens, counts, stats = _spec_run(mt, params, prompts, MT_NEW,
                                           ModelDrafter(mt, params), paged=True,
                                           adapter_ids=aids, max_len=MT_MAX_LEN)
    launches = _want_spec_launches("serve_multi_tenant_spec", eng, counts, paged=True)
    require(stats["acceptance_rate"] == 1.0,
            f"serve_multi_tenant_spec: a per-adapter self-draft accepted "
            f"{stats['acceptance_rate']}")
    compared = _tenant_agree("serve_multi_tenant_spec vs serve_multi_tenant", mt, params,
                             prompts, aids, tokens, mt_tokens)
    emit({"phase": "serve_multi_tenant_spec", "speculate_k": SPEC_K, "drafter":
          "ModelDrafter(mt, params): per-adapter self-draft", "page_size": 16,
          **stats, **launches, "launches": counts, "tokens_compared": compared,
          "serve_multi_tenant_same_call": mt_stats,
          "round_vs_step": (stats["round_ms_p50"] / mt_stats["decode_ms_per_step_p50"]
                            if stats["round_ms_p50"] else None),
          "memory": eng.snapshot()["memory"], "card": card})
    return counts


def _lora_llama():
    from elephas_tpu_torch.models import TransformerLM

    model = TransformerLM(**dict(LLAMA3_8B, n_layers=LLAMA_TRAIN_LAYERS), device="cuda")
    return model, draw_params(model, SEED + 31)


def train_lora(card, llama):
    """``apply_lora(params, keys=("wq", "wv"), rank=16)`` on ``train_llama``'s
    model and initial weights, stepped by ``build_lora_lm_train_step(model,
    None, adam(1e-3), attn="flash")`` on its batch of 4 x 2048: the first
    loss equal to ``train_llama``'s (B starts at 0); 2 warm-up and 3 timed
    steps, finite and falling; every frozen tensor bit-identical after the
    steps and every ``b`` moved; optimizer state at most 2 x trainable + 16
    elements; exactly L launches of each rope-on-load K2 kernel a step and
    none of the plain ones. Then ``merge_lora``: the merged apply against
    the adapted one; ``save_lora`` / ``load_lora``: the same logits bits."""
    import os
    import tempfile

    from elephas_tpu_torch.models import (LoRATensor, adam, apply_lora,
                                          build_lora_lm_train_step, load_lora,
                                          lora_trainable_count, make_lm_batches,
                                          merge_lora, save_lora)

    L = LLAMA_TRAIN_LAYERS
    model, base = _lora_llama()
    frozen = {k: v.cpu() for k, v in base.items()}     # on the host: off the peak
    params = apply_lora(base, keys=LORA_KEYS, rank=LORA_RANK)
    B, T = 4, 2048
    rows = np.random.default_rng(SEED + 32).integers(0, LLAMA3_8B["vocab"],
                                                     size=(B, T + 1))
    batch = tuple(torch.from_numpy(a).cuda() for a in make_lm_batches(rows))
    step, opt_init = build_lora_lm_train_step(model, None, adam(1e-3), attn="flash")
    state = opt_init(params)
    trainable, total = lora_trainable_count(params)
    state_elems = (state.inner_state.count.numel()
                   + sum(t.numel() for t in state.inner_state.mu.values())
                   + sum(t.numel() for t in state.inner_state.nu.values()))
    require(state_elems <= 2 * trainable + 16,
            f"train_lora: {state_elems} optimizer-state elements for {trainable} trainable")
    params, state, warm, _, _ = _llama_steps(step, params, state, batch, 2)
    torch.cuda.reset_peak_memory_stats()
    n_steps = 3
    params, state, timed, wall, counts = _llama_steps(step, params, state, batch, n_steps)
    peak = torch.cuda.max_memory_allocated()
    losses = warm + timed
    require(all(np.isfinite(losses)), f"train_lora: non-finite loss in {losses}")
    require(losses[-1] < losses[0], f"train_lora: loss did not fall: {losses}")
    first_rel = abs(losses[0] - llama["first_loss"]) / abs(llama["first_loss"])
    require(first_rel <= 1e-6, f"train_lora: first loss {losses[0]} vs train_llama's "
                               f"{llama['first_loss']} (B = 0 starts at the base)")
    _want_rope_launches("train_lora", counts, L, n_steps)
    for k, v in params.items():
        w = v.w if isinstance(v, LoRATensor) else v
        require(torch.equal(w.cpu(), frozen[k]), f"train_lora: frozen {k} changed")
        if isinstance(v, LoRATensor):
            require(bool(v.b.abs().max() > 0), f"train_lora: {k}.b did not move")
    del frozen
    # the merged weights against the adapted ones on one row of the batch
    tok, pos = batch[0][:1, :512], batch[1][:1, :512]
    with torch.no_grad():
        adapted = model.apply(params, tok, pos, attn="flash")
        merged = model.apply(merge_lora(params), tok, pos, attn="flash")
        merge_err = float((adapted - merged).abs().max())
        require(merge_err <= 1e-5 * max(1.0, float(adapted.abs().max())),
                f"train_lora: merged logits off by {merge_err}")
        with tempfile.TemporaryDirectory() as d:
            path = f"{d}/adapters.npz"
            save_lora(path, params)
            size = os.path.getsize(path)
            reloaded = model.apply(load_lora(path, base), tok, pos, attn="flash")
        require(torch.equal(reloaded, adapted), "train_lora: save/load changed the logits")
    emit({"phase": "train_lora", "model": f"Llama-3-8B widths, {L} of 32 layers "
          "(train_llama's initial weights, seed 31)", "dtype": "float32",
          "lora_keys": list(LORA_KEYS), "lora_rank": LORA_RANK, "optimizer": "adam(1e-3)",
          "attn": "flash", "batch": B, "seq_len": T, "trainable": trainable, "total": total,
          "optimizer_state_elements": state_elems, "warmup_steps": 2, "timed_steps": n_steps,
          "ms_per_step": wall * 1e3 / n_steps, "tokens_per_s": n_steps * B * T / wall,
          "peak_mem_gb": peak / 1e9, "losses": losses, "train_llama": llama,
          "first_loss_rel_diff_to_train_llama": first_rel,
          "launches": counts, "launches_per_step": {k: v / n_steps for k, v in counts.items()},
          "merge_max_abs_err": merge_err, "merge_tol": "1e-5 of the logits' scale",
          "saved_adapters_bytes": size, "card": card})
    return params, counts


def lora_cross_check(card, params):
    """One LoRA step's loss and every adapter factor's gradient at B 1, T
    128, one layer of ``train_lora``'s trained weights (its factors, ``b``
    nonzero), on the card against ``device="cpu"``: loss rtol 1e-4, each
    gradient within 1e-3 of its scale, floored at 1e-4 of the largest."""
    from elephas_tpu_torch.models import (TransformerLM, adam, build_lora_lm_train_step,
                                          make_lm_batches)

    rows = np.random.default_rng(SEED + 55).integers(0, LLAMA3_8B["vocab"], size=(1, 129))
    batch = make_lm_batches(rows)
    out = {}
    for dev in ("cuda", "cpu"):
        model = TransformerLM(**dict(LLAMA3_8B, n_layers=1), device=dev)
        p = _layer_slice(model, params, dev)
        step, _ = build_lora_lm_train_step(model, None, adam(1e-3), attn="flash")
        _zero_counters()
        loss, grads = step.grad(p, *batch)
        if dev == "cuda":
            _want_rope_launches("lora_cross_check", _read_counters(), 1, 1)
        out[dev] = (float(loss), {f"{k}.{f}": getattr(g, f).cpu() for k, g in grads.items()
                                  if g is not None for f in ("a", "b")})
        del p, grads
    (lg, gg), (lc, gc) = out["cuda"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    require(loss_rel <= 1e-4, f"lora_cross_check: loss {lg} vs cpu {lc}")
    floor = 1e-4 * max(float(g.abs().max()) for g in gc.values())
    grad_rel = {k: float((gg[k].double() - gc[k].double()).abs().max())
                / max(float(gc[k].abs().max()), floor) for k in gc}
    worst = max(grad_rel, key=grad_rel.get)
    require(grad_rel[worst] <= 1e-3, f"lora_cross_check: gradient of {worst} off by "
                                     f"{grad_rel[worst]} of its scale")
    emit({"phase": "lora_cross_check", "layers": 1, "batch": 1, "seq_len": 128,
          "loss_gpu": lg, "loss_cpu": lc, "loss_rel_diff": loss_rel, "loss_rtol": 1e-4,
          "grad_err_rel_to_scale": grad_rel, "scale_floor": floor, "grad_tol": 1e-3,
          "card": card})


# -- phases 28a to 28i: the LM remainder (sliding windows, beam search, phases) ---

# Mistral-7B-v0.1's widths, from its config.json (the repo's `mistral` family,
# models/hf_import.py:128-177, sets attn_window=sliding_window); depth is the
# only cut, as train_llama's
MISTRAL_7B = dict(vocab=32000, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
                  max_len=32768, activation="swiglu", ffn_bias=False, norm="rmsnorm",
                  norm_eps=1e-5, pos_encoding="rotary", rope_theta=10000.0,
                  attn_bias=False, tie_embeddings=False, attn_window=4096)
MISTRAL_LAYERS = 4
WINDOW = 4096
# the Qwen2 layer_types / Gemma-2 alternation hf_import maps to a per-layer list
MIXED_WINDOWS = (WINDOW, None, WINDOW, None)
WINDOW_SERVE_LEN = 4864          # the serving engines' max_len: 304 pages of 16


def _mistral(**kw):
    from elephas_tpu_torch.models import TransformerLM

    return TransformerLM(**dict(MISTRAL_7B, n_layers=MISTRAL_LAYERS, **kw), device="cuda")


@contextlib.contextmanager
def _watch(*names):
    """Record, per call of the attention entries ``names`` of
    ``models/transformer.py`` inside the block, the ``(window, ring, rows)``
    the model passed: proof of which kernel branch the main path took. It
    wraps each call in Python, so the phases use it on an untimed run of
    the same path (their warm-up) and time a run without it."""
    import elephas_tpu_torch.models.transformer as tr

    seen = {n: collections.Counter() for n in names}
    saved = {n: getattr(tr, n) for n in names}

    def wrap(n, fn):
        sig = inspect.signature(fn)

        def call(*a, **kw):
            args = sig.bind(*a, **kw).arguments
            seen[n][(args.get("window"), bool(args.get("ring", False)),
                     int(a[0].shape[0]))] += 1
            return fn(*a, **kw)
        return call

    for n, fn in saved.items():
        setattr(tr, n, wrap(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(tr, n, fn)


def _seen(counter):
    return [{"window": w, "ring": r, "rows": b, "calls": c}
            for (w, r, b), c in sorted(counter.items(), key=str)]


def _dev_normal(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _window_mask(T, window, device="cuda"):
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    return (j <= i) & (j > i - window)


def check_window_kernels(card):
    """The windowed branches of K2 (rope on load: ``train_window``; plain,
    on rotated q and k: ``generate_window``'s prefill), K4 (``ring=True``:
    ``generate_window``; a window on a linear cache: ``serve_window``) and
    K5 (decode and chunk: ``serve_window_paged``) at Mistral-7B's head
    shapes and the shapes those paths give them, each against its plain
    version at its existing tolerance, twice for the same bits, and timed
    beside the plain version, SDPA with an explicit window (or ring-age)
    mask and the bound (only the visible (query, key) pairs, or the
    window's K/V rows). Returns ``{kernel: {path: case}}``."""
    from elephas_tpu_torch.models.transformer import _rope_angles
    from elephas_tpu_torch.ops.flash_attention import (
        attention_fwd_reference, flash_attention_fwd, flash_attention_rope_dkv,
        flash_attention_rope_dq, flash_attention_rope_fwd, make_rope_tables,
        rope_attention_bwd_reference, rope_attention_fwd_reference)
    from elephas_tpu_torch.ops.flash_decode import (
        aligned_cache_length, decode_attention_reference_lse, flash_decode_lse)
    from elephas_tpu_torch.ops.paged_attention import (
        paged_chunk_reference, paged_decode_reference_lse, paged_flash_chunk,
        paged_flash_decode_lse)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    f32 = torch.float32
    out = {}

    # K2 rope-on-load, the train_window shape: B 1, H 32, Hkv 8, T 8192
    B, H, Hkv, T, Dh = 1, 32, 8, 8192, 128
    pos = torch.arange(T, device="cuda")[None]
    c2, s2 = make_rope_tables(*_rope_angles(pos, Dh, MISTRAL_7B["rope_theta"]))
    sets = []
    for _ in range(2):
        q, k, v, do = (_dev_normal(gen, B, T, h, Dh) for h in (H, Hkv, Hkv, H))
        wo, wl = rope_attention_fwd_reference(q, k, v, c2, s2, True, WINDOW)
        delta = (do * wo).sum(-1).transpose(1, 2).contiguous()
        sets.append((q, k, v, do, wl, delta, c2, s2))
        del wo
    q, k, v, do, wl, delta, _, _ = sets[0]
    o, lse = flash_attention_rope_fwd(q, k, v, c2, s2, True, WINDOW)
    wo, wl2 = rope_attention_fwd_reference(q, k, v, c2, s2, True, WINDOW)
    fwd_err = max(_allclose_err(o, wo, 2e-5), _allclose_err(lse, wl2, 2e-5))
    require(fwd_err[1], f"window K2-fwd rope: max abs err {fwd_err[0]} beyond 2e-5")
    require(all(torch.equal(a, b) for a, b in zip(
        flash_attention_rope_fwd(q, k, v, c2, s2, True, WINDOW), (o, lse))),
        "window K2-fwd rope: two launches differ")
    del o, lse, wo, wl2
    bwd = sets[0] + (True, WINDOW)
    dq = flash_attention_rope_dq(*bwd)
    dk, dv = flash_attention_rope_dkv(*bwd)
    require(torch.equal(flash_attention_rope_dq(*bwd), dq)
            and all(torch.equal(a, b) for a, b in zip(flash_attention_rope_dkv(*bwd), (dk, dv))),
            "window K2-dq/dkv rope: two launches differ")
    want = rope_attention_bwd_reference(*bwd)
    dq_err = _allclose_err(dq, want[0], 2e-5)
    dkv_err = max(_allclose_err(dk, want[1], 2e-5), _allclose_err(dv, want[2], 2e-5))
    require(dq_err[1] and dkv_err[1],
            f"window K2 rope backward: dq {dq_err[0]}, dk/dv {dkv_err[0]} beyond 2e-5")
    del dq, dk, dv, want
    torch.cuda.empty_cache()
    n = 10
    k2_ms = {
        "fwd": device_ms(lambda q, k, v, do, lse, delta, c2, s2:
                         flash_attention_rope_fwd(q, k, v, c2, s2, True, WINDOW), sets, n),
        "dq": device_ms(lambda *a: flash_attention_rope_dq(*a, True, WINDOW), sets, n),
        "dkv": device_ms(lambda *a: flash_attention_rope_dkv(*a, True, WINDOW), sets, n)}
    plain_fwd = device_ms(lambda q, k, v, do, lse, delta, c2, s2:
                          rope_attention_fwd_reference(q, k, v, c2, s2, True, WINDOW),
                          sets[:1], 2)
    torch.cuda.empty_cache()
    plain_bwd = device_ms(lambda *a: rope_attention_bwd_reference(*a, True, WINDOW),
                          sets[:1], 2)
    torch.cuda.empty_cache()
    # SDPA on the rotated q, k with an explicit window mask, KV heads
    # repeated (no single call computes rope and attention)
    from elephas_tpu_torch.ops.flash_attention import _rope_apply

    mask = _window_mask(T, WINDOW)
    lib = []
    for q, k, v, do, *_ in sets:
        qr = _rope_apply(q, c2, s2).transpose(1, 2)
        kr = _rope_apply(k, c2, s2).repeat_interleave(H // Hkv, 2).transpose(1, 2)
        lib.append((qr, kr, v.repeat_interleave(H // Hkv, 2).transpose(1, 2),
                    do.transpose(1, 2)))
    with torch.no_grad():
        lib_fwd = device_ms(lambda q, k, v, do: sdpa(q, k, v, attn_mask=mask), lib, n)
    graphs = []
    for q, k, v, do in lib:
        args = [t.detach().requires_grad_() for t in (q, k, v)]
        graphs.append((sdpa(*args, attn_mask=mask), args, do))
    lib_bwd = device_ms(lambda o, args, do: torch.autograd.grad(o, args, do, retain_graph=True),
                        graphs, n)
    del graphs, lib, sets
    torch.cuda.empty_cache()
    pairs = B * H * _visible_pairs(T, True, WINDOW)
    qb, kb, stat, tab = B * T * H * Dh * 4, B * T * Hkv * Dh * 4, B * H * T * 4, 2 * B * T * Dh * 4
    rot_q, rot_k = 3 * B * T * H * Dh, 3 * B * T * Hkv * Dh
    k2 = {}
    for name, ms, plain_ms, lib_ms, n_bytes, n_ops, err in (
            ("flash_attention_rope_fwd", k2_ms["fwd"], plain_fwd, lib_fwd,
             2 * qb + 2 * kb + stat + tab, 4 * Dh * pairs + rot_q + rot_k, fwd_err[0]),
            ("flash_attention_rope_dq", k2_ms["dq"], plain_bwd, lib_bwd,
             3 * qb + 2 * kb + 2 * stat + tab, 6 * Dh * pairs + 2 * rot_q + rot_k, dq_err[0]),
            ("flash_attention_rope_dkv", k2_ms["dkv"], plain_bwd, lib_bwd,
             2 * qb + 4 * kb + 2 * stat + tab, 8 * Dh * pairs + rot_q + 2 * rot_k, dkv_err[0])):
        bms, by, simt_ms = k2_bound_ms(n_bytes, n_ops)
        k2[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library": ("F.scaled_dot_product_attention on pre-rotated q, k with an "
                                "explicit window mask" + ("" if name.endswith("fwd") else
                                                          ", its autograd backward (dq, dk, dv)")),
                    "bound_ms": bms, "bound_by": by, "bound_simt_ms": simt_ms,
                    "visible_pairs": pairs, "max_abs_err": err, "atol": 2e-5, "same_bits": True,
                    "shape": {"B": B, "H": H, "Hkv": Hkv, "T": T, "Dh": Dh, "window": WINDOW,
                              "theta": MISTRAL_7B["rope_theta"], "dtype": "float32"}}
    out.update({name: {"train_window": case} for name, case in k2.items()})

    # K2-fwd with the window on rotated q and k: generate_window's prefill,
    # B 2 prompts of 4608 (the model rotates, then calls flash_attention)
    B, T = 2, 4608
    fsets = [tuple(_dev_normal(gen, B, T, h, Dh) for h in (H, Hkv, Hkv)) for _ in range(2)]
    q, k, v = fsets[0]
    o, lse = flash_attention_fwd(q, k, v, True, WINDOW)
    wo, wl = attention_fwd_reference(q, k, v, True, WINDOW)
    err = max(_allclose_err(o, wo, 2e-5), _allclose_err(lse, wl, 2e-5))
    require(err[1], f"window K2-fwd T {T}: max abs err {err[0]} beyond 2e-5")
    require(all(torch.equal(a, b) for a, b in zip(flash_attention_fwd(q, k, v, True, WINDOW),
                                                  (o, lse))),
            "window K2-fwd: two launches differ")
    del o, lse, wo, wl
    torch.cuda.empty_cache()
    fwd_ms = device_ms(lambda q, k, v: flash_attention_fwd(q, k, v, True, WINDOW), fsets, 10)
    plain_ms = device_ms(lambda q, k, v: attention_fwd_reference(q, k, v, True, WINDOW),
                         fsets[:1], 2)
    torch.cuda.empty_cache()
    mask = _window_mask(T, WINDOW)
    lib = [(q.transpose(1, 2), *(x.repeat_interleave(H // Hkv, 2).transpose(1, 2)
                                 for x in (k, v))) for q, k, v in fsets]
    with torch.no_grad():
        lib_ms = device_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=mask), lib, 10)
    del lib, fsets, mask
    torch.cuda.empty_cache()
    pairs = B * H * _visible_pairs(T, True, WINDOW)
    qb, kb, stat = B * T * H * Dh * 4, B * T * Hkv * Dh * 4, B * H * T * 4
    bms, by, simt_ms = k2_bound_ms(2 * qb + 2 * kb + stat, 4 * Dh * pairs)
    out["flash_attention_fwd"] = {"generate_window": {
        "ms": fwd_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "library": "F.scaled_dot_product_attention with an explicit window mask, KV heads "
                   "repeated",
        "bound_ms": bms, "bound_by": by, "bound_simt_ms": simt_ms, "visible_pairs": pairs,
        "max_abs_err": err[0], "atol": 2e-5, "same_bits": True,
        "shape": {"B": B, "H": H, "Hkv": Hkv, "T": T, "Dh": Dh, "causal": True,
                  "window": WINDOW, "rope": "applied before the call", "dtype": "float32"}}}

    # K4 on a rolling cache: generate_window's ring of aligned(4096 + 1) slots
    Bd, hkv, g, dh = 2, 8, 4, 128
    Tr = aligned_cache_length(WINDOW + 1)
    checks = []
    for ps in ([4000, 4095], [4096, 4351], [4352, 4700], [0, 4700]):
        p_t = torch.tensor(ps, dtype=torch.int32, device="cuda")
        q, k, v = _dev_normal(gen, Bd, hkv, g, dh), *(_dev_normal(gen, Bd, hkv, Tr, dh)
                                                      for _ in range(2))
        got = flash_decode_lse(q, k, v, p_t, window=WINDOW, ring=True)
        want = decode_attention_reference_lse(q, k, v, p_t, WINDOW, True)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        require(err <= 1e-5, f"K4 ring at {ps}: max abs err {err} > 1e-5")
        require(all(torch.equal(a, b) for a, b in zip(
            flash_decode_lse(q, k, v, p_t, window=WINDOW, ring=True), got)),
            f"K4 ring at {ps}: two launches differ")
        checks.append({"pos": ps, "max_abs_err": err})
    ps = [4600, 4700]
    p_t = torch.tensor(ps, dtype=torch.int32, device="cuda")
    slots = torch.arange(Tr, device="cuda")
    age = torch.remainder(p_t.long()[:, None] - slots[None, :], Tr)
    ring_mask = (age < torch.clamp(p_t.long()[:, None] + 1, max=WINDOW))[:, None, None, :]
    dsets = [(_dev_normal(gen, Bd, hkv, g, dh), _dev_normal(gen, Bd, hkv, Tr, dh),
              _dev_normal(gen, Bd, hkv, Tr, dh), p_t) for _ in range(8)]
    vis = sum(_visible(ps, Tr, WINDOW, ring=True))
    bms, by = bound_ms(vis * hkv * dh * 2 * 4 + (2 * Bd * hkv * g * dh + Bd * hkv * g + Bd) * 4,
                       vis * hkv * g * dh * 4)
    out["flash_decode_lse"] = {"generate_window": {
        "ms": device_ms(lambda q, k, v, p: flash_decode_lse(q, k, v, p, window=WINDOW, ring=True),
                        dsets),
        "plain_ms": device_ms(lambda q, k, v, p: decode_attention_reference_lse(
            q, k, v, p, WINDOW, True), dsets),
        "library_ms": device_ms(lambda q, k, v, p: sdpa(q, k, v, attn_mask=ring_mask), dsets),
        "library": "F.scaled_dot_product_attention with an explicit ring-age mask",
        "bound_ms": bms, "bound_by": by, "max_abs_err": max(c["max_abs_err"] for c in checks),
        "atol": 1e-5, "same_bits": True, "checks": checks,
        "shape": {"B": Bd, "Hkv": hkv, "G": g, "Dh": dh, "T": Tr, "window": WINDOW,
                  "ring": True, "pos": ps, "kv_dtype": "float32"}}}
    del dsets

    # K4 with the window on a linear cache: serve_window's 4 slots of
    # WINDOW_SERVE_LEN positions, decoding at 4200-4631
    Bs, Tl = 4, WINDOW_SERVE_LEN
    checks = []
    for ps in ([4200, 4400, 4600, 4631], [4095, 4096, 4097, Tl - 1], [0, 17, 4000, 4300]):
        p_t = torch.tensor(ps, dtype=torch.int32, device="cuda")
        q, k, v = _dev_normal(gen, Bs, hkv, g, dh), *(_dev_normal(gen, Bs, hkv, Tl, dh)
                                                      for _ in range(2))
        got = flash_decode_lse(q, k, v, p_t, window=WINDOW)
        want = decode_attention_reference_lse(q, k, v, p_t, WINDOW)
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        require(err <= 1e-5, f"K4 window at {ps}: max abs err {err} > 1e-5")
        require(all(torch.equal(a, b) for a, b in zip(
            flash_decode_lse(q, k, v, p_t, window=WINDOW), got)),
            f"K4 window at {ps}: two launches differ")
        checks.append({"pos": ps, "max_abs_err": err})
    ps = [4200, 4400, 4600, 4631]
    p_t = torch.tensor(ps, dtype=torch.int32, device="cuda")
    j = torch.arange(Tl, device="cuda")[None, :]
    lin_mask = ((j <= p_t.long()[:, None]) & (j > p_t.long()[:, None] - WINDOW))[:, None, None, :]
    dsets = [(_dev_normal(gen, Bs, hkv, g, dh), _dev_normal(gen, Bs, hkv, Tl, dh),
              _dev_normal(gen, Bs, hkv, Tl, dh), p_t) for _ in range(8)]
    vis = sum(_visible(ps, Tl, WINDOW))
    bms, by = bound_ms(vis * hkv * dh * 2 * 4 + (2 * Bs * hkv * g * dh + Bs * hkv * g + Bs) * 4,
                       vis * hkv * g * dh * 4)
    out["flash_decode_lse"]["serve_window"] = {
        "ms": device_ms(lambda q, k, v, p: flash_decode_lse(q, k, v, p, window=WINDOW), dsets),
        "plain_ms": device_ms(lambda q, k, v, p: decode_attention_reference_lse(
            q, k, v, p, WINDOW), dsets),
        "library_ms": device_ms(lambda q, k, v, p: sdpa(q, k, v, attn_mask=lin_mask), dsets),
        "library": "F.scaled_dot_product_attention with an explicit window mask",
        "bound_ms": bms, "bound_by": by, "max_abs_err": max(c["max_abs_err"] for c in checks),
        "atol": 1e-5, "same_bits": True, "checks": checks,
        "shape": {"B": Bs, "Hkv": hkv, "G": g, "Dh": dh, "T": Tl, "window": WINDOW,
                  "ring": False, "pos": ps, "kv_dtype": "float32"}}
    del dsets

    # K5-decode and K5-chunk with the window: serve_window_paged's 4 slots
    # at positions past 4096 and its insert (one slot, a chunk of 4864 rows
    # at 0, the bucket the engine pads a 4200-4600-token prompt to)
    S, page, M = 4, 16, WINDOW_SERVE_LEN // 16

    def pool(S, pos, C=None):
        P = S * M + 1
        kp, vp = (_dev_normal(gen, P, hkv, page, dh) for _ in range(2))
        kp[0] = vp[0] = 1e4          # the trash page: never to reach an output
        table = (1 + torch.randperm(S * M, generator=gen, device="cuda")).reshape(S, M)
        last = torch.tensor(pos, device="cuda") + (0 if C is None else C - 1)
        cells = torch.arange(M, device="cuda")[None, :]
        table = torch.where(cells > (last // page)[:, None], 0, table).to(torch.int32)
        q = _dev_normal(gen, *((S, hkv, g, dh) if C is None else (S, hkv, g, C, dh)))
        return q, kp, vp, table, torch.tensor(pos, dtype=torch.int32, device="cuda")

    dec_pos = [4200, 4400, 4600, 4631]
    psets = [pool(S, dec_pos) for _ in range(4)]
    q, kp, vp, t, p = psets[0]
    got = paged_flash_decode_lse(q, kp, vp, t, p, page, WINDOW)
    want = paged_decode_reference_lse(q, kp, vp, t, p, page, WINDOW)
    err = max(_allclose_err(a, b, 2e-5) for a, b in zip(got, want))
    require(err[1], f"K5-decode window at {dec_pos}: max abs err {err[0]} beyond 2e-5")
    require(all(torch.equal(a, b) for a, b in zip(
        paged_flash_decode_lse(q, kp, vp, t, p, page, WINDOW), got)),
        "K5-decode window: two launches differ")
    Tp = M * page
    dmask = ((torch.arange(Tp, device="cuda")[None, :] <= p.long()[:, None])
             & (torch.arange(Tp, device="cuda")[None, :] > p.long()[:, None] - WINDOW))
    lib_sets = [(q, *_dense_view(kp, vp, t, page), dmask[:, None, None, :])
                for q, kp, vp, t, p in psets]
    vis = sum(_visible(dec_pos, Tp, WINDOW))
    pages = sum(min(x // page + 1, WINDOW // page + 1) for x in dec_pos)
    bms, by = bound_ms(vis * hkv * dh * 2 * 4 + (2 * S * hkv * g * dh + S * hkv * g + S) * 4
                       + pages * 4, vis * hkv * g * dh * 4)
    out["paged_flash_decode_lse"] = {"serve_window_paged": {
        "ms": device_ms(lambda q, kp, vp, t, p: paged_flash_decode_lse(
            q, kp, vp, t, p, page, WINDOW), psets),
        "plain_ms": device_ms(lambda q, kp, vp, t, p: paged_decode_reference_lse(
            q, kp, vp, t, p, page, WINDOW), psets),
        "library_ms": device_ms(lambda q, k, v, m: sdpa(q, k, v, attn_mask=m), lib_sets),
        "library": "F.scaled_dot_product_attention over the equivalent dense cache with an "
                   "explicit window mask",
        "bound_ms": bms, "bound_by": by, "max_abs_err": err[0], "atol": 2e-5,
        "same_bits": True,
        "shape": {"S": S, "Hkv": hkv, "G": g, "Dh": dh, "page": page, "M": M,
                  "window": WINDOW, "pos": dec_pos, "kv_dtype": "float32"}}}
    del psets, lib_sets
    C = WINDOW_SERVE_LEN
    csets = [pool(1, [0], C) for _ in range(2)]
    q, kp, vp, t, p = csets[0]
    got = paged_flash_chunk(q, kp, vp, t, p, page, WINDOW)
    err = _allclose_err(got, paged_chunk_reference(q, kp, vp, t, p, page, WINDOW), 2e-5)
    require(err[1] and bool(torch.isfinite(got).all()),
            f"K5-chunk window C {C}: max abs err {err[0]} beyond 2e-5")
    require(torch.equal(paged_flash_chunk(q, kp, vp, t, p, page, WINDOW), got),
            "K5-chunk window: two launches differ")
    del got
    cmask = _window_mask(C, WINDOW)[None, None]
    lib_sets = [(q[0].reshape(1, hkv * g, C, dh),
                 *(x.repeat_interleave(g, 1) for x in _dense_view(kp, vp, t, page)))
                for q, kp, vp, t, p in csets]
    cpairs = hkv * g * _visible_pairs(C, True, WINDOW)
    bms, by, simt_ms = k2_bound_ms(C * hkv * dh * 2 * 4 + 2 * hkv * g * C * dh * 4
                                   + (C // page) * 4 + 4, 4 * dh * cpairs)
    out["paged_flash_chunk"] = {"serve_window_paged": {
        "ms": device_ms(lambda q, kp, vp, t, p: paged_flash_chunk(q, kp, vp, t, p, page, WINDOW),
                        csets, 10),
        "plain_ms": device_ms(lambda q, kp, vp, t, p: paged_chunk_reference(
            q, kp, vp, t, p, page, WINDOW), csets, 2),
        "library_ms": device_ms(lambda q, k, v: sdpa(q, k, v, attn_mask=cmask), lib_sets, 10),
        "library": "F.scaled_dot_product_attention over the equivalent dense cache with an "
                   "explicit window mask",
        "bound_ms": bms, "bound_by": by, "bound_simt_ms": simt_ms, "visible_pairs": cpairs,
        "max_abs_err": err[0], "atol": 2e-5, "same_bits": True,
        "shape": {"S": 1, "Hkv": hkv, "G": g, "C": C, "Dh": dh, "page": page, "M": M,
                  "pos0": [0], "window": WINDOW, "kv_dtype": "float32"}}}
    del csets, lib_sets
    torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernel": "window_shapes", **out, "card": card})
    return out


def _walled(name, fn, *args):
    """``fn(*args)``, then a line with its wall seconds (set-up, checks and
    timed runs together)."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase": "wall", "of": name, "seconds": time.perf_counter() - t0})
    return out


def _gaps_and_argmax(logits):
    top = torch.topk(logits, 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu(), logits.argmax(dim=-1).cpu()


def _near_tie_equal(what, got, want, gaps):
    """Rows of ``got`` equal ``want`` up to each row's first near tie (top-2
    gap 1e-3 or less); returns how many positions each row compared."""
    compared = []
    for r in range(got.shape[0]):
        n = 0
        while n < got.shape[1] and float(gaps[r, n]) > 1e-3:
            require(int(got[r, n]) == int(want[r, n]),
                    f"{what}: row {r} position {n}: {int(got[r, n])} != {int(want[r, n])} "
                    f"(gap {float(gaps[r, n])})")
            n += 1
        compared.append(n)
    return compared


def generate_window(card):
    """Mistral-7B widths at 4 layers, one window of 4096 on every layer:
    greedy ``generate`` of 64 tokens after prompts of 4608 at B 2 over a
    rolling cache of ``aligned_cache_length(4096 + 1)`` slots (the prompt
    takes ``write_prompt_cache``'s scatter branch); exact launches (L K2-fwd
    for the prefill, L K4 with ``ring=True`` a decode step); the tokens
    against the argmax of the card's own ``apply(attn="dense")`` up to near
    ties; the same weights without the window give other logits past 4096;
    then a windowed ``generate_speculative`` self-draft at ``spec_k=4``."""
    from elephas_tpu_torch.ops.flash_decode import aligned_cache_length

    L = MISTRAL_LAYERS
    model = _mistral()
    params = draw_params(model, SEED + 41)
    V = MISTRAL_7B["vocab"]
    B, T0, n_new = 2, 4608, 64
    prompt = torch.from_numpy(np.random.default_rng(SEED + 42).integers(
        0, V, size=(B, T0))).cuda()
    shapes = []
    init_cache = model.init_cache

    def recording(*a, **kw):
        c = init_cache(*a, **kw)
        shapes.append(tuple(c["k"].shape))
        return c

    model.init_cache = recording
    n_watch = 3                  # the warm-up, at the same prompts, watched
    with _watch("decode_attention", "flash_attention") as seen:
        model.generate(params, prompt, n_watch)
    torch.cuda.synchronize()
    shapes.clear()
    _zero_counters()
    t0 = time.perf_counter()
    out = model.generate(params, prompt, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    Tr = aligned_cache_length(WINDOW + 1)
    Dh = MISTRAL_7B["d_model"] // MISTRAL_7B["n_heads"]
    require(shapes == [(L, B, MISTRAL_7B["n_kv_heads"], Tr, Dh)],
            f"generate_window: caches {shapes}, want one of {Tr} slots")
    require(T0 > Tr, "generate_window: the prompt must take the scatter branch")
    require(tuple(out.shape) == (B, T0 + n_new), f"generate_window: shape {tuple(out.shape)}")
    require(counts["flash_attention_fwd"] == L,
            f"generate_window: {counts['flash_attention_fwd']} K2-fwd launches, want {L}")
    require(counts["flash_decode_lse"] == L * (n_new - 1),
            f"generate_window: {counts['flash_decode_lse']} K4 launches, want "
            f"{L} x {n_new - 1}")
    require(dict(seen["decode_attention"]) == {(WINDOW, True, B): L * (n_watch - 1)},
            f"generate_window: K4 calls {_seen(seen['decode_attention'])}")
    require(dict(seen["flash_attention"]) == {(WINDOW, False, B): L},
            f"generate_window: K2-fwd calls {_seen(seen['flash_attention'])}")
    for name in ROPE_ROWS + ("flash_attention_dq", "flash_attention_dkv",
                             "paged_flash_decode_lse", "paged_flash_chunk"):
        require(counts[name] == 0, f"generate_window: {name} launched")

    with torch.no_grad():
        seq = out[:, :-1].long()
        pos = torch.arange(seq.shape[1], device="cuda").expand(B, -1)
        logits = model.apply(params, seq, pos, attn="dense")
        gaps, argmax = _gaps_and_argmax(logits[:, T0 - 1:])
        past = logits[:, WINDOW:].clone()
        del logits
        torch.cuda.empty_cache()
        full = _mistral(attn_window=None)
        diff = float((full.apply(params, seq, pos, attn="dense")[:, WINDOW:] - past)
                     .abs().max())
        del past
        torch.cuda.empty_cache()
    compared = _near_tie_equal("generate_window vs apply(dense)", out[:, T0:].cpu(), argmax,
                               gaps)
    require(diff > 0, "generate_window: the window changed no logit past 4096")

    # speculative decoding on the margined ring: a self-draft, B 1, 32 new
    spec_k, n_spec = 4, 32
    shapes.clear()
    t0 = time.perf_counter()
    spec, stats = model.generate_speculative(params, prompt[:1], n_spec, model, params,
                                             spec_k=spec_k, with_stats=True)
    torch.cuda.synchronize()
    spec_wall = time.perf_counter() - t0
    want_T = aligned_cache_length(WINDOW + spec_k + 1)
    require(shapes == [(L, 1, MISTRAL_7B["n_kv_heads"], want_T, Dh)] * 2,
            f"generate_window spec: caches {shapes}, want two of {want_T} slots")
    spec_compared = _near_tie_equal("generate_window spec vs greedy",
                                    spec[:, T0:].cpu(), out[:1, T0:T0 + n_spec].cpu(),
                                    gaps[:1])
    emit({"phase": "generate_window", "model": f"Mistral-7B-v0.1 widths, {L} of 32 layers "
          "(random weights, seed 41)", "attn_window": WINDOW, "batch": B, "prompt_len": T0,
          "n_new": n_new, "ring_slots": Tr, "wall_s": wall, "tok_per_s": B * n_new / wall,
          "launches": counts, "watched_run": {"n_new": n_watch,
                                              "k4_calls": _seen(seen["decode_attention"]),
                                              "k2_fwd_calls": _seen(seen["flash_attention"])},
          "tokens_compared_with_dense_apply": compared, "min_gap": float(gaps.min()),
          "no_window_max_logit_diff_past_4096": diff,
          "speculative": {"spec_k": spec_k, "batch": 1, "n_new": n_spec, "ring_slots": want_T,
                          "wall_s": spec_wall, "tok_per_s": n_spec / spec_wall, **stats,
                          "tokens_compared_with_greedy": spec_compared},
          "card": card})
    model.init_cache = init_cache
    return params, counts


def train_window(card, params):
    """Mistral-7B widths, 4 layers, float32: ``build_lm_train_step(attn=
    "flash", vocab_block=8192)`` with ``adam_compact(1e-3)`` on one batch of
    1 x 8192 tokens, 1 warm-up and 2 timed steps, exactly L rope-on-load
    K2-fwd, dq and dkv a step, each with ``window=4096``; then one layer at
    B 1, T 4608 against ``attn="dense"`` on the card at
    ``train_llama_cross_check``'s tolerances."""
    from elephas_tpu_torch.models import (TransformerLM, adam_compact, build_lm_train_step,
                                          make_lm_batches)

    L = MISTRAL_LAYERS
    model = _mistral()
    B, T = 1, 8192
    rows = np.random.default_rng(SEED + 43).integers(0, MISTRAL_7B["vocab"], size=(B, T + 1))
    batch = tuple(torch.from_numpy(a).cuda() for a in make_lm_batches(rows))
    step, opt_init = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash",
                                         vocab_block=8192)
    p = {k: v.clone() for k, v in params.items()}
    state = opt_init(p)
    with _watch("flash_attention_rope") as seen:      # the warm-up step, watched
        p, state, warm, _, _ = _llama_steps(step, p, state, batch, 1)
    torch.cuda.reset_peak_memory_stats()
    n_steps = 2
    p, state, timed, wall, counts = _llama_steps(step, p, state, batch, n_steps)
    peak = torch.cuda.max_memory_allocated()
    del p, state
    losses = warm + timed
    require(all(np.isfinite(losses)), f"train_window: non-finite loss in {losses}")
    require(losses[-1] < losses[0], f"train_window: loss did not fall: {losses}")
    _want_rope_launches("train_window", counts, L, n_steps)
    require(dict(seen["flash_attention_rope"]) == {(WINDOW, False, B): L},
            f"train_window: rope calls {_seen(seen['flash_attention_rope'])}")
    torch.cuda.empty_cache()

    # one layer at full width, B 1, T 4608: flash against dense on the card
    m1 = TransformerLM(**dict(MISTRAL_7B, n_layers=1), device="cuda")
    p1 = _layer_slice(m1, params, "cuda")
    rows1 = np.random.default_rng(SEED + 44).integers(0, MISTRAL_7B["vocab"], size=(1, 4609))
    b1 = make_lm_batches(rows1)
    out = {}
    for attn in ("flash", "dense"):
        st, _ = build_lm_train_step(m1, None, adam_compact(1e-3), attn=attn, vocab_block=8192)
        _zero_counters()
        loss, grads = st.grad(p1, *b1)
        if attn == "flash":
            _want_rope_launches("train_window_cross_check", _read_counters(), 1, 1)
        out[attn] = (float(loss), {k: g.double().cpu() for k, g in grads.items()})
        del grads
        torch.cuda.empty_cache()
    (lf, gf), (ld, gd) = out["flash"], out["dense"]
    loss_rel = abs(lf - ld) / abs(ld)
    require(loss_rel <= 1e-4, f"train_window cross check: loss {lf} vs dense {ld}")
    floor = 1e-4 * max(float(g.abs().max()) for g in gd.values())
    grad_rel = {k: float((gf[k] - gd[k]).abs().max()) / max(float(gd[k].abs().max()), floor)
                for k in gd}
    worst = max(grad_rel, key=grad_rel.get)
    require(grad_rel[worst] <= 1e-3,
            f"train_window cross check: gradient of {worst} off by {grad_rel[worst]} of its scale")
    emit({"phase": "train_window", "model": f"Mistral-7B-v0.1 widths, {L} of 32 layers "
          "(random weights, seed 41)", "attn_window": WINDOW, "dtype": "float32",
          "optimizer": "adam_compact(1e-3)", "attn": "flash", "vocab_block": 8192,
          "batch": B, "seq_len": T, "warmup_steps": 1, "timed_steps": n_steps,
          "ms_per_step": wall * 1e3 / n_steps, "tokens_per_s": n_steps * B * T / wall,
          "peak_mem_gb": peak / 1e9, "losses": losses, "launches": counts,
          "launches_per_step": {k: v / n_steps for k, v in counts.items()},
          "warmup_step_rope_calls": _seen(seen["flash_attention_rope"]),
          "cross_check": {"layers": 1, "batch": 1, "seq_len": 4608, "against": "attn='dense'",
                          "loss_flash": lf, "loss_dense": ld, "loss_rel_diff": loss_rel,
                          "loss_rtol": 1e-4, "grad_err_rel_to_scale": grad_rel,
                          "scale_floor": floor, "grad_tol": 1e-3},
          "card": card})
    return counts


def _serve_window_run(what, model, params, prompts, paged):
    from elephas_tpu_torch.serving import ServingEngine

    kw = dict(n_slots=4, max_len=WINDOW_SERVE_LEN, paged=paged, page_size=16, device="cuda")
    names = (("paged_decode_attention", "paged_chunk_attention") if paged
             else ("decode_attention",))
    warm = ServingEngine(model, params, **kw)
    with _watch(*names) as seen:        # the warm-up, same prompts, watched
        _drain(warm, prompts, 3)
    w_snap = warm.snapshot()["engine"]
    w_steps, w_inserts = w_snap["decode_steps"], w_snap["prefills"]
    del warm
    L = MISTRAL_LAYERS
    half = L // 2
    require(w_steps > 0 and w_inserts == len(prompts),
            f"{what}: the watched run took {w_steps} steps, {w_inserts} inserts")
    step_calls = {(WINDOW, False, 4): half * w_steps, (None, False, 4): half * w_steps}
    eng = ServingEngine(model, params, **kw)
    _zero_counters()
    fin, wall = _drain(eng, prompts, 32)
    counts = _read_counters()
    snap = eng.snapshot()
    steps, inserts = snap["engine"]["decode_steps"], snap["engine"]["prefills"]
    if paged:
        eng.kv.check()
        require(counts["paged_flash_decode_lse"] == L * steps,
                f"{what}: K5-decode {counts['paged_flash_decode_lse']}, want {L} x {steps}")
        require(counts["paged_flash_chunk"] == L * inserts,
                f"{what}: K5-chunk {counts['paged_flash_chunk']}, want {L} x {inserts}")
        require(counts["flash_decode_lse"] == 0, f"{what}: K4 launched")
        require(dict(seen["paged_decode_attention"]) == step_calls,
                f"{what}: K5-decode calls {_seen(seen['paged_decode_attention'])}")
        require(dict(seen["paged_chunk_attention"]) == {
            (WINDOW, False, 1): half * w_inserts, (None, False, 1): half * w_inserts},
            f"{what}: K5-chunk calls {_seen(seen['paged_chunk_attention'])}")
    else:
        require(counts["flash_decode_lse"] == L * steps,
                f"{what}: K4 {counts['flash_decode_lse']}, want {L} x {steps}")
        require(counts["paged_flash_decode_lse"] + counts["paged_flash_chunk"] == 0,
                f"{what}: a paged kernel launched")
        require(dict(seen["decode_attention"]) == step_calls,
                f"{what}: K4 calls {_seen(seen['decode_attention'])}")
    return eng, fin, wall, counts, snap, {"watched_run": {
        "n_new": 3, "decode_steps": w_steps, "prefills": w_inserts,
        **{n: _seen(c) for n, c in seen.items()}}}


def serve_window(card, params):
    """Mistral-7B widths with the per-layer windows ``(4096, None, 4096,
    None)`` (a linear cache: two layers attend fully) behind
    ``ServingEngine(n_slots=4, max_len=4864)``: 4 greedy requests of
    4200-4600 prompt tokens and 32 new, dense (K4 with each layer's
    window) and then paged at page 16 (K5-decode and K5-chunk with it):
    exact launches, ``kv.check()``, paged tokens against dense up to near
    ties."""
    model = _mistral(attn_window=MIXED_WINDOWS)
    gen = np.random.default_rng(SEED + 45)
    prompts = [gen.integers(0, MISTRAL_7B["vocab"], size=int(n)).astype(np.int32)
               for n in gen.integers(4200, 4601, size=4)]
    rows = {}
    for paged, what in ((False, "serve_window"), (True, "serve_window_paged")):
        eng, fin, wall, counts, snap, calls = _serve_window_run(what, model, params, prompts,
                                                                paged)
        tokens = [f.tokens for f in fin]
        rows[what] = (counts, tokens, _serving_stats(snap, fin, wall), snap, calls)
        del eng
        torch.cuda.empty_cache()
    compared = _agree("serve_window_paged vs serve_window", model, params, prompts,
                      rows["serve_window_paged"][1], rows["serve_window"][1])
    for what, (counts, tokens, stats, snap, calls) in rows.items():
        emit({"phase": what, "model": f"Mistral-7B-v0.1 widths, {MISTRAL_LAYERS} of 32 "
              "layers (random weights, seed 41)", "attn_window": list(MIXED_WINDOWS),
              "requests": 4, "new_tokens_each": 32,
              "prompt_lens": [int(len(p)) for p in prompts],
              "decode_steps": snap["engine"]["decode_steps"],
              "prefills": snap["engine"]["prefills"], "launches": counts,
              "attention_calls": calls, **stats,
              **({"page_size": 16, "memory": snap["memory"],
                  "tokens_compared_with_dense": compared} if what.endswith("paged") else {}),
              "card": card})
    return rows["serve_window"][0], rows["serve_window_paged"][0]


def beam_phase(card, params):
    """``generate_beam`` at GPT-2-small width: B 2, prompts of 64, 32 new;
    ``beam_size=1`` equal to greedy ``generate`` bit for bit, then
    ``beam_size=4``: exactly L K2-fwd (the prefill) and L K4 launches a
    step over the B·K = 8 rows."""
    from elephas_tpu_torch.models import TransformerLM, generate_beam

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    L = GPT2_SMALL["n_layers"]
    B, T0, n_new, K = 2, 64, 32, 4
    prompt = torch.from_numpy(np.random.default_rng(SEED + 46).integers(
        0, GPT2_SMALL["vocab"], size=(B, T0))).cuda()
    greedy = model.generate(params, prompt, n_new)
    beam1, score1 = generate_beam(model, params, prompt, n_new, beam_size=1)
    require(torch.equal(beam1, greedy), "beam: beam_size=1 differs from greedy generate")
    n_watch = 4                  # the warm-up, at the same prompts, watched
    with _watch("decode_attention") as seen:
        generate_beam(model, params, prompt, n_watch, beam_size=K)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    seqs, scores = generate_beam(model, params, prompt, n_new, beam_size=K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    require(tuple(seqs.shape) == (B, T0 + n_new) and bool(torch.isfinite(scores).all()),
            f"beam: shape {tuple(seqs.shape)}, scores {scores.tolist()}")
    require(torch.equal(seqs[:, :T0], prompt.to(torch.int32)), "beam: the prompt changed")
    require(counts["flash_attention_fwd"] == L, f"beam: {counts['flash_attention_fwd']} K2-fwd")
    require(counts["flash_decode_lse"] == L * (n_new - 1),
            f"beam: {counts['flash_decode_lse']} K4 launches, want {L} x {n_new - 1}")
    require(dict(seen["decode_attention"]) == {(None, False, B * K): L * (n_watch - 1)},
            f"beam: K4 calls {_seen(seen['decode_attention'])}")
    emit({"phase": "beam", "model": "gpt2-small (random weights, seed 0)", "batch": B,
          "prompt_len": T0, "n_new": n_new, "beam_size": K, "wall_s": wall,
          "tok_per_s": B * n_new / wall, "scores": scores.tolist(),
          "greedy_scores": score1.tolist(), "beam1_equals_greedy": True,
          "launches": counts, "watched_run": {"n_new": n_watch,
                                              "k4_calls": _seen(seen["decode_attention"])},
          "card": card})
    return counts


def _timed(fn, n=3):
    """Median wall ms of ``fn()`` over ``n`` calls, the card synchronised
    around each, and the last result."""
    times, out = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def train_phases(card, params):
    """``build_lm_train_phases`` on ``train``'s GPT-2 step (B 8 x T 1024,
    ``attn="flash"``, ``adam_compact(1e-3)``): the forward, the forward and
    backward, the optimizer phase and the whole step, each timed; the
    phases' losses equal the step's, and ``apply(params, state,
    reduce(grad(...)[1]))`` is the step's update bit for bit."""
    from elephas_tpu_torch.models import (TransformerLM, adam_compact, build_lm_train_phases,
                                          build_lm_train_step, make_lm_batches)

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    B, T = 8, 1024
    rows = np.random.default_rng(SEED + 4).integers(0, GPT2_SMALL["vocab"], size=(B, T + 1))
    batch = tuple(torch.from_numpy(a).cuda() for a in make_lm_batches(rows))
    opt = adam_compact(1e-3)
    ph = build_lm_train_phases(model, None, opt, attn="flash")
    step, opt_init = build_lm_train_step(model, None, opt, attn="flash")
    state = opt_init(params)
    step_ms, (p_step, s_step, loss_step) = _timed(lambda: step(params, state, *batch))
    fwd_ms, loss_fwd = _timed(lambda: ph["loss"](params, *batch))
    grad_ms, (loss_grad, grads) = _timed(lambda: ph["grad"](params, *batch))
    grads = ph["reduce"](grads)
    apply_ms, (p_apply, s_apply) = _timed(lambda: ph["apply"](params, state, grads))
    require(torch.equal(loss_grad, loss_step),
            f"train_phases: grad loss {float(loss_grad)} != step loss {float(loss_step)}")
    require(torch.equal(loss_fwd, loss_step),
            f"train_phases: forward loss {float(loss_fwd)} != step loss {float(loss_step)}")
    bad = [k for k in p_step if not torch.equal(p_apply[k], p_step[k])]
    require(not bad, f"train_phases: apply(grad) differs from the step in {bad[:5]}")
    emit({"phase": "train_phases", "model": "gpt2-small (random weights, seed 0)",
          "batch": B, "seq_len": T, "attn": "flash", "optimizer": "adam_compact(1e-3)",
          "fwd_ms": fwd_ms, "grad_ms": grad_ms, "bwd_ms": grad_ms - fwd_ms,
          "apply_ms": apply_ms, "step_ms": step_ms,
          "phases_sum_ms": grad_ms + apply_ms, "loss": float(loss_step),
          "losses_equal_step": True, "apply_of_grad_equals_step_bitwise": True,
          "card": card})
    del p_step, s_step, p_apply, s_apply, grads


def train_options(card):
    """The step's options never run on the card before, each once against
    the identity its CPU test pins, at a reduced depth: Llama-3-8B widths at
    1 layer (B 2 x T 1024, ``attn="flash"``, 3 steps each from the same
    weights): ``remat="dots"`` and ``"full"`` (first loss rtol 1e-5, the
    trajectory 5e-3, against ``"none"``), ``accum_steps=2`` (rtol 1e-5),
    ``fused_apply`` (losses and params bit for bit); Mixtral-8x7B widths at
    1 layer (B 2 x T 512): ``ep_groups=2`` on ``attn="dense"`` at
    capacity factor 1.0 (its routing then differs from one group's), the
    K6 executor against the capacity-slot executor (loss rtol 1e-5,
    gradients 1e-3 of scale), and bf16 expert storage against float32: the
    first update at lr 1e-3 (every expert stack moves, by the float32
    run's change on the bf16 grid), then 4 steps at lr 1e-4 (rtol 1e-1,
    falling; experts stay bf16, the router float32)."""
    from elephas_tpu_torch.models import (MoETransformerLM, TransformerLM, adam_compact,
                                          build_lm_train_step, make_lm_batches)

    out = {}
    model = TransformerLM(**dict(LLAMA3_8B, n_layers=1), device="cuda")
    params = draw_params(model, SEED + 47)
    rows = np.random.default_rng(SEED + 48).integers(0, LLAMA3_8B["vocab"], size=(2, 1025))
    batch = tuple(torch.from_numpy(a).cuda() for a in make_lm_batches(rows))
    runs = {}
    for name, knobs in (("none", {}), ("remat_dots", dict(remat="dots")),
                        ("remat_full", dict(remat="full")), ("accum_steps_2",
                                                             dict(accum_steps=2)),
                        ("fused_apply", dict(fused_apply=True))):
        step, opt_init = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash",
                                             **knobs)
        p = params
        state = opt_init(p)
        losses = []
        t0 = time.perf_counter()
        for _ in range(3):
            p, state, loss = step(p, state, *batch)
            losses.append(loss)
        torch.cuda.synchronize()
        runs[name] = ([float(x) for x in losses], (time.perf_counter() - t0) * 1e3 / 3,
                      p if name in ("none", "fused_apply") else None)
        del state
    base = runs["none"][0]
    for name in ("remat_dots", "remat_full"):
        got = runs[name][0]
        require(abs(got[0] - base[0]) <= 1e-5 * abs(base[0]),
                f"train_options {name}: first loss {got[0]} vs {base[0]}")
        require(np.allclose(got, base, rtol=5e-3, atol=1e-5),
                f"train_options {name}: losses {got} vs {base}")
    require(np.allclose(runs["accum_steps_2"][0], base, rtol=1e-5, atol=1e-6),
            f"train_options accum_steps=2: losses {runs['accum_steps_2'][0]} vs {base}")
    require(runs["fused_apply"][0] == base
            and all(torch.equal(runs["fused_apply"][2][k], runs["none"][2][k])
                    for k in runs["none"][2]),
            "train_options fused_apply: not bit for bit the unfused step")
    out["llama_1_layer"] = {name: {"losses": r[0], "ms_per_step": r[1]}
                            for name, r in runs.items()}
    del runs, params
    torch.cuda.empty_cache()

    moe_cfg = dict(MIXTRAL_8X7B, n_layers=1)
    # capacity 1.0 binds, so the dispatch groups change the routing
    ep_cfg = dict(moe_cfg, capacity_factor=1.0)
    rows = np.random.default_rng(SEED + 49).integers(0, MIXTRAL_8X7B["vocab"], size=(2, 513))
    mbatch = make_lm_batches(rows)
    mparams = draw_params(MoETransformerLM(**moe_cfg, device="cuda"), SEED + 50)
    grads = {}
    for dispatch in ("gmm", "slots"):
        m = MoETransformerLM(**dict(ep_cfg, ep_groups=2, moe_dispatch=dispatch),
                             device="cuda")
        st, _ = build_lm_train_step(m, None, adam_compact(1e-3), attn="dense")
        _zero_counters()
        loss, g = st.grad(mparams, *mbatch)
        if dispatch == "gmm":
            c = _read_counters()
            require(c["gmm"] > 0 and c["tgmm"] > 0, f"train_options ep_groups: gmm {c['gmm']}")
        grads[dispatch] = (float(loss), g)
        del g
    (lg, gg), (ls, gs) = grads["gmm"], grads["slots"]
    floor = 1e-4 * max(float(v.abs().max()) for v in gs.values())
    ep_rel = {k: float((gg[k].float() - gs[k].float()).abs().max())
              / max(float(gs[k].abs().max()), floor) for k in gs}
    worst = max(ep_rel, key=ep_rel.get)
    require(abs(lg - ls) <= 1e-5 * abs(ls), f"train_options ep_groups=2: loss {lg} vs {ls}")
    require(ep_rel[worst] <= 1e-3,
            f"train_options ep_groups=2: gradient of {worst} off by {ep_rel[worst]}")
    del grads, gg, gs
    one_group = MoETransformerLM(**dict(ep_cfg, ep_groups=1), device="cuda")
    st1, _ = build_lm_train_step(one_group, None, adam_compact(1e-3), attn="dense")
    l1 = float(st1.grad(mparams, *mbatch)[0])
    require(l1 != lg, f"train_options ep_groups: 1 and 2 groups give the same loss {l1}")
    out["mixtral_ep_groups_2"] = {"loss_gmm": lg, "loss_slots": ls,
                                  "grad_err_rel_to_scale": ep_rel, "grad_tol": 1e-3,
                                  "loss_ep_groups_1": l1, "capacity_factor": 1.0}
    del mparams
    torch.cuda.empty_cache()
    # bf16 expert storage, first its update: one step at lr 1e-3 from the
    # same draws (bf16 storage rounds them); each expert stack must move,
    # and its change must be the float32 run's change put on the bf16 grid
    # (bf16(p0 + d32) - p0) but where a gradient near 0 changes sign
    experts = ("w1", "w2", "w3")
    d32, upd = {}, {}
    for pd in ("float32", "bfloat16"):
        m = MoETransformerLM(**dict(moe_cfg, param_dtype=pd), device="cuda")
        p = draw_params(m, SEED + 50)
        step, opt_init = build_lm_train_step(m, None, adam_compact(1e-3), attn="flash")
        p1, state, _ = step(p, opt_init(p), *mbatch)
        del state
        for k in experts:
            if pd == "float32":
                d32[k] = p1[k] - p[k]
                continue
            b0, db = p[k].float(), p1[k].float() - p[k].float()
            grid = (b0 + d32[k]).to(torch.bfloat16).float() - b0
            upd[k] = {"moved": float((db != 0).float().mean()),
                      "on_grid_equal": float((db == grid).float().mean()),
                      "rel_l2": float((db - d32[k]).norm() / d32[k].norm())}
            del b0, db, grid
        if pd == "bfloat16":
            require(p1["w1"].dtype == torch.bfloat16 and p1["wg"].dtype == torch.float32,
                    f"train_options bf16 experts: w1 {p1['w1'].dtype}, wg {p1['wg'].dtype}")
        del p, p1, step
        torch.cuda.empty_cache()
    del d32
    for k, u in upd.items():
        require(u["moved"] >= 0.99 and u["on_grid_equal"] >= 0.98 and u["rel_l2"] <= 0.25,
                f"train_options bf16 experts: {k}'s first update {u} (want moved >= 0.99, "
                f"on the bf16 grid equal >= 0.98, relative L2 <= 0.25)")
    # then the CPU pin's identity, four steps tracking float32 within rtol
    # 1e-1 and falling, at lr 1e-4. At 1e-3 (the rate every other train
    # phase here uses; the CPU pin's adam takes 1e-2 at its small width)
    # this width memorises the one batch, 10.5 to ~1.0 in four steps, and
    # the two runs part by 27% at the fourth; the rate was lowered for
    # that, so the storage itself is held at 1e-3 by the first update above
    losses = {}
    for pd in ("float32", "bfloat16"):
        m = MoETransformerLM(**dict(moe_cfg, param_dtype=pd), device="cuda")
        p = draw_params(m, SEED + 50)
        step, opt_init = build_lm_train_step(m, None, adam_compact(1e-4), attn="flash")
        state = opt_init(p)
        ls_ = []
        for _ in range(4):
            p, state, loss = step(p, state, *mbatch)
            ls_.append(float(loss))
        losses[pd] = ls_
        del p, state
        torch.cuda.empty_cache()
    require(np.allclose(losses["bfloat16"], losses["float32"], rtol=1e-1),
            f"train_options bf16 experts: {losses['bfloat16']} vs {losses['float32']}")
    require(losses["bfloat16"][-1] < losses["bfloat16"][0],
            f"train_options bf16 experts: loss did not fall: {losses['bfloat16']}")
    out["mixtral_bf16_experts"] = {"first_update_lr": 1e-3, "first_update": upd,
                                   "trajectory_lr": 1e-4, **losses}
    emit({"phase": "train_options", **out, "card": card})


# -- phases 29 to 32: the Keras layers of the repo's examples ----------------------

# The committed Keras JSON of each model (written once with Keras; the card has
# none): examples/mnist_cnn_async.py:24-40's CNN with a linear Dense(10) and
# from_logits=True; the same CNN with a BatchNormalization after each Conv2D;
# examples/ml_pipeline_imdb_lstm.py:30-41's Embedding(2000, 32) -> LSTM(32) ->
# Dense(1, sigmoid) built at (None, 80). Widths are the examples'; epochs are
# cut to 2 (the CNN example runs 3).
CNN_JSON = "elephas_tpu_torch/configs/mnist_cnn_logits.json"
CNN_BN_JSON = "elephas_tpu_torch/configs/mnist_cnn_bn.json"
LSTM_JSON = "elephas_tpu_torch/configs/imdb_lstm.json"
CNN_FIT = dict(samples=16384, held_out=2048, batch=64, workers=8, epochs=2,
               host_workers=2)
BN_FIT = dict(samples=16384, batch=64, workers=8, epochs=2, validation_split=0.1)
LSTM_FIT = dict(samples=8192, batch=32, workers=8, epochs=2, vocab=2000, maxlen=80)


def imdb_like(n: int, vocab: int, maxlen: int, seed: int = 0):
    """Integer ids in [0, vocab) at length ``maxlen`` as float64 (the example
    feeds ``x.astype("float64")``), labelled 1 where the mean of the last
    four ids is under ``vocab / 2``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, size=(n, maxlen))
    y = (x[:, -4:].mean(1) < vocab / 2).astype(np.float32)[:, None]
    return x.astype(np.float64), y


def _json_model(path, device="cuda", **kw):
    from elephas_tpu_torch import SparkModel

    with open(path) as f:
        return SparkModel(f.read(), device=device, **kw)


def _compiled_fit(what, sm, rdd, epochs, batch, split, S, Sv, k1=True, remat=False,
                  falls=True):
    """One compiled-path fit with the launch counts set to 0 just before and
    read just after: ``(wall s, counts, history)``, after checking finite
    losses (falling, with ``falls``) and exactly E (S + Sv) K1-fwd and E S
    K1-bwd launches (E (2S + Sv) K1-fwd under ``remat``: the backward runs
    the loss again; ``k1``; a sigmoid head launches no kernel of the port:
    none at all)."""
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    sm.fit(rdd, epochs=epochs, batch_size=batch, validation_split=split)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    hist = sm.training_histories[-1]
    require(all(np.isfinite(v).all() for v in hist.values()), f"{what}: non-finite {hist}")
    require(not falls or hist["loss"][-1] < hist["loss"][0],
            f"{what}: loss did not fall: {hist['loss']}")
    want = ({"fused_xent_fwd": epochs * ((2 if remat else 1) * S + Sv),
             "fused_xent_bwd": epochs * S} if k1 else {})
    for name, n in want.items():
        require(counts[name] == n, f"{what}: {name} launched {counts[name]} times, want "
                                   f"{n} (E {epochs}, S {S}, Sv {Sv})")
    others = {k: v for k, v in counts.items() if k not in want and v}
    require(not others, f"{what}: other kernels launched: {others}")
    return wall, counts, hist


def fit_cnn(card):
    """``examples/mnist_cnn_async.py``'s three fits of its CNN (the committed
    JSON, logits head) at full width on 16384 MNIST-shaped samples, batch 64,
    ``frequency="epoch"``, ``merge="mean"``, no validation, 2 epochs:
    asynchronous and hogwild on the compiled path (8 workers), then
    asynchronous over HTTP on the host path (2 worker threads). Exact K1
    counts (compiled: E S each way; host: sum over workers of E S_w),
    falling losses, held-out accuracy over 0.5; samples/s and ms a step of
    a second fit of the same geometry (the data staged); a profiled 1-epoch
    fit of the asynchronous compiled run."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = CNN_FIT
    (x, y), (xt, yt) = mnist_like(c["samples"], c["held_out"])
    W, E, B = c["workers"], c["epochs"], c["batch"]
    S, Sv = _mlp_steps(c["samples"], W, B, 0.0)
    rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x, y, num_slices=W)
    n_train = W * (c["samples"] // W)
    runs, main_counts = [], None
    for mode in ("asynchronous", "hogwild"):
        sm = _json_model(CNN_JSON, mode=mode, frequency="epoch", parameter_server_mode="jax",
                         num_workers=W, merge="mean")
        wall, counts, hist = _compiled_fit(f"fit_cnn {mode}", sm, rdd, E, B, 0.0, S, Sv)
        main_counts = main_counts or counts
        t0 = time.perf_counter()
        sm.fit(rdd, epochs=E, batch_size=B, validation_split=0.0)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        loss, acc = sm.evaluate(xt, yt)
        require(np.isfinite(loss) and acc > 0.5, f"fit_cnn {mode}: held-out accuracy {acc}")
        runs.append({"mode": mode, "path": "compiled", "workers": W, "first_fit_s": wall,
                     "fit_s": wall2, "samples_per_s": n_train * E / wall2,
                     "ms_per_step": wall2 * 1e3 / (E * S), "history": hist,
                     "launches": {k: v for k, v in counts.items() if v},
                     "held_out_eval": {"loss": loss, "accuracy": acc}})
        if mode == "asynchronous":
            runs[-1]["profiled_fit_1_epoch"] = profiled(
                lambda: sm.fit(rdd, epochs=1, batch_size=B, validation_split=0.0), 1,
                top_n=10)
    Wh = c["host_workers"]
    sm = _json_model(CNN_JSON, mode="asynchronous", frequency="epoch",
                     parameter_server_mode="http", num_workers=Wh, port=0, merge="mean")
    wall, host_counts, hists, _ = _host_fit("fit_cnn host", sm, x, y, Wh, E, B, 0.0, "epoch")
    loss, acc = sm.evaluate(xt, yt)
    require(np.isfinite(loss) and acc > 0.5, f"fit_cnn host: held-out accuracy {acc}")
    Sh, _ = _host_steps(c["samples"], Wh, B, 0.0, "epoch")
    runs.append({"mode": "asynchronous", "path": "host http", "workers": Wh, "fit_s": wall,
                 "samples_per_s": n_train * E / wall,
                 "worker_ms_per_step": wall * 1e3 / (E * Sh), "histories": hists,
                 "launches": {k: v for k, v in host_counts.items() if v},
                 "held_out_eval": {"loss": loss, "accuracy": acc}})
    emit({"phase": "fit_cnn", "config": CNN_JSON, **c, "steps_per_epoch": S,
          "host_steps_per_epoch": Sh, "fits": runs, "card": card})
    return main_counts, host_counts


def fit_bn(card):
    """The BatchNormalization CNN (``mnist_cnn_bn.json``), 8 workers, 16384
    samples, batch 64, 2 epochs, ``validation_split=0.1`` (each replica
    validates with its own statistics): synchronous at ``frequency="epoch"``
    and at ``"batch"`` (gradient-synchronous: each worker normalises over
    its own rows), then asynchronous epoch merges (``merge="mean"``). Exact
    K1 counts, falling losses; the moving statistics moved, finite, the
    variances positive. Then a synchronous epoch fit through
    ``CompiledTrainer(keep_worker_state=True)``: the installed parameters
    and statistics are the mean merge of the replica stacks, within 1e-6 of
    scale."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.models import KerasModelAdapter
    from elephas_tpu_torch.parallel import CompiledTrainer
    from elephas_tpu_torch.utils import to_simple_rdd

    c = BN_FIT
    (x, y), _ = mnist_like(c["samples"], 0)
    W, E, B, split = c["workers"], c["epochs"], c["batch"], c["validation_split"]
    S, Sv = _mlp_steps(c["samples"], W, B, split)
    rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x, y, num_slices=W)
    runs, main_counts = [], None
    for mode, freq, merge in [("synchronous", "epoch", "auto"), ("synchronous", "batch", "auto"),
                              ("asynchronous", "epoch", "mean")]:
        sm = _json_model(CNN_BN_JSON, mode=mode, frequency=freq, parameter_server_mode="jax",
                         num_workers=W, merge=merge)
        before = {k: v.cpu() for k, v in sm.master_network.state_values()[1].items()}
        wall, counts, hist = _compiled_fit(f"fit_bn {mode}/{freq}", sm, rdd, E, B, split,
                                           S, Sv)
        main_counts = main_counts or counts
        after = {k: v.cpu() for k, v in sm.master_network.state_values()[1].items()}
        require(len(after) == 4, f"fit_bn: {len(after)} statistics, want 4")
        for k, v in after.items():
            require(bool(torch.isfinite(v).all()) and not torch.equal(v, before[k]),
                    f"fit_bn {mode}/{freq}: {k} did not move or is not finite")
            require(not k.endswith("variance") or bool((v > 0).all()),
                    f"fit_bn {mode}/{freq}: {k} not positive")
        runs.append({"mode": mode, "frequency": freq, "merge": merge, "fit_s": wall,
                     "ms_per_step": wall * 1e3 / (E * S), "history": hist,
                     "launches": {k: v for k, v in counts.items() if v},
                     "moving_stat_means": {k: float(v.mean()) for k, v in after.items()}})
    with open(CNN_BN_JSON) as f:
        trainer = CompiledTrainer(KerasModelAdapter(f.read(), device="cuda"),
                                  mode="synchronous")
    per = c["samples"] // W
    blocks = [(x[i * per:(i + 1) * per], y[i * per:(i + 1) * per]) for i in range(W)]
    res = trainer.fit(blocks, epochs=1, batch_size=B, validation_split=split,
                      keep_worker_state=True)
    ws = res.worker_state
    tv, ntv = trainer.adapter.state_values()
    merge_err = 0.0
    for stack, base, got in ((ws["tv_stack"], ws["base_tv"], tv),
                             (ws["ntv_stack"], ws["base_ntv"], ntv)):
        for k, b in base.items():
            want = b - (b[None] - stack[k]).mean(0)
            err = float((got[k] - want).abs().max() / max(float(want.abs().max()), 1.0))
            merge_err = max(merge_err, err)
    require(merge_err <= 1e-6, f"fit_bn: installed weights {merge_err} from the merge")
    emit({"phase": "fit_bn", "config": CNN_BN_JSON, **c, "steps_per_epoch": S,
          "val_steps_per_epoch": Sv, "fits": runs,
          "installed_vs_mean_merge_err_rel": merge_err, "card": card})
    return main_counts


def fit_lstm(card):
    """``examples/ml_pipeline_imdb_lstm.py``'s model (the committed JSON) at
    full width through ``SparkModel.fit``: ids below 2000 at length 80 from
    the seed, 8192 samples, batch 32, 8 workers, synchronous, 2 epochs, no
    validation (the example's). Falling loss; no kernel of the port
    launched (a sigmoid head); ms a step of a second fit; the device's busy
    share of one profiled epoch over a quarter of the rows (80 recurrent
    steps of small launches a batch, forward and backward: host-bound)."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = LSTM_FIT
    x, y = imdb_like(c["samples"], c["vocab"], c["maxlen"])
    W, E, B = c["workers"], c["epochs"], c["batch"]
    S, Sv = _mlp_steps(c["samples"], W, B, 0.0)
    rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x, y, num_slices=W)
    sm = _json_model(LSTM_JSON, mode="synchronous", num_workers=W)
    wall, counts, hist = _compiled_fit("fit_lstm", sm, rdd, E, B, 0.0, S, Sv, k1=False)
    t0 = time.perf_counter()
    sm.fit(rdd, epochs=E, batch_size=B, validation_split=0.0)
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    # the profiled epoch over an eighth of the rows (its 4 steps are the fit's
    # steps; the profiler's trace of ~2,600 launches a step is what takes time)
    part = to_simple_rdd(SparkContext(f"local[{W}]"), x[:len(x) // 8], y[:len(y) // 8],
                         num_slices=W)
    prof = profiled(lambda: sm.fit(part, epochs=1, batch_size=B, validation_split=0.0),
                    1, top_n=10)
    prof["steps_per_epoch"] = _mlp_steps(len(x) // 8, W, B, 0.0)[0]
    emit({"phase": "fit_lstm", "config": LSTM_JSON, **c, "steps_per_epoch": S,
          "first_fit_s": wall, "history": hist, "fit_s": wall2,
          "ms_per_step": wall2 * 1e3 / (E * S),
          "samples_per_s": W * (c["samples"] // W) * E / wall2,
          "profiled_fit_1_epoch": prof, "card": card})


def _bn_steps(dev, x, y):
    """One step of each schedule's step function on the BatchNormalization
    CNN from its initial state (4 replicas of 64 rows, the last replica's
    last 24 rows padding): the local schedules' train step and the
    gradient-synchronous grad step. ``(compared, adam_updated)``: the loss
    sums, moved statistics and gradients by name; the train step's
    parameters after Adam."""
    from elephas_tpu_torch.models import KerasModelAdapter

    with open(CNN_BN_JSON) as f:
        a = KerasModelAdapter(f.read(), device=dev)
    L, B = 4, 64
    xs = torch.from_numpy(x[:L * B].reshape(L, B, 784)).to(dev)
    ys = torch.from_numpy(y[:L * B].reshape(L, B, 10)).to(dev)
    sw = torch.ones(L, B, device=dev)
    sw[3, 40:] = 0.0
    tv, ntv = a.state_values()
    stack = {k: v[None].expand((L,) + tuple(v.shape)).clone() for k, v in tv.items()}
    nstack = {k: v[None].expand((L,) + tuple(v.shape)).clone() for k, v in ntv.items()}
    opt = a.make_optimizer()
    tv2, ntv2, _, st = a.build_train_step(opt)(stack, nstack, opt.init(stack, count_shape=(L,)),
                                               xs, ys, sw, None)
    grads, gntv, gst = a.build_grad_step()(tv, nstack, xs, ys, sw, None)
    compared = {**{f"train_step {k}": v for k, v in ntv2.items()},
                **{f"train_step stats[{i}]": v for i, v in enumerate(st)},
                **{f"grad_step d{k}": v for k, v in grads.items()},
                **{f"grad_step {k}": v for k, v in gntv.items()},
                **{f"grad_step stats[{i}]": v for i, v in enumerate(gst)}}
    return ({k: v.cpu() for k, v in compared.items()}, {k: v.cpu() for k, v in tv2.items()})


def fit_layers_cross_check(card):
    """Each of the three models fitted on the card and on ``device="cpu"``
    from the same weights (the config's initializers, seed 0) and the same
    order (drawn on the host), synchronous at epoch frequency, 4 workers, 2
    epochs, ``validation_split=0.1`` (the models have no dropout):
    histories within rtol 1e-4 and every weight (moving statistics
    included) within 1e-4 of its array's largest entry, as
    ``fit_cross_check``. The BatchNormalization CNN's gradient-synchronous
    schedule is held step by step instead: one train step and one grad
    step from the same state and batch on the card and the CPU, the loss
    sums, gradients and moved statistics within 1e-4 of scale, and by its
    held-out predictions after a fit from the same weights and order on
    each device: the largest softmax-probability difference over 1024 rows
    and the argmax agreement on the rows whose top-2 logit margin (the
    CPU's) exceeds 1e-3 are printed. (Its fit is not held: Adam's first step moves a parameter whose summed gradient is near
    zero by the learning rate in the direction of that gradient's
    rounding, so 1e-6 differences in the gradient become 3e-3 of a
    convolution bias's scale after one step on an H100; the Adam-updated
    parameters' error is printed.)"""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    (x, y), _ = mnist_like(1024, 0)
    xi, yi = imdb_like(512, LSTM_FIT["vocab"], LSTM_FIT["maxlen"], seed=1)
    cases = [("mnist_cnn_logits", CNN_JSON, x, y, 64), ("mnist_cnn_bn", CNN_BN_JSON, x, y, 64),
             ("imdb_lstm", LSTM_JSON, xi, yi, 32)]
    checks = []
    for name, path, xs, ys, B in cases:
        out = {}
        for dev in ("cuda", "cpu"):
            sm = _json_model(path, device=dev, mode="synchronous", num_workers=4)
            sm.fit(to_simple_rdd(SparkContext("local[4]"), xs, ys, num_slices=4), epochs=2,
                   batch_size=B, validation_split=0.1)
            out[dev] = (sm.training_histories[-1], sm.master_network.get_weights())
        hist_err = max(abs(a - b) / max(abs(b), 1e-6) for k in out["cpu"][0]
                       for a, b in zip(out["cuda"][0][k], out["cpu"][0][k]))
        w_err = max(float(np.abs(a - b).max()) / float(np.abs(b).max() or 1.0)
                    for a, b in zip(out["cuda"][1], out["cpu"][1]))
        require(hist_err <= 1e-4, f"fit_layers_cross_check {name}: histories differ by "
                                  f"{hist_err} (relative): {out['cuda'][0]} vs {out['cpu'][0]}")
        require(w_err <= 1e-4, f"fit_layers_cross_check {name}: weights differ by {w_err} "
                               f"of scale")
        checks.append({"model": name, "frequency": "epoch", "history_rel_err": hist_err,
                       "weight_err_rel_to_scale": w_err, "tol": 1e-4,
                       "history_gpu": out["cuda"][0], "history_cpu": out["cpu"][0]})
    (gpu, gpu_adam), (cpu, cpu_adam) = _bn_steps("cuda", x, y), _bn_steps("cpu", x, y)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)

    step_err = {k: rel(gpu[k], cpu[k]) for k in cpu}
    worst = max(step_err, key=step_err.get)
    require(step_err[worst] <= 1e-4, f"fit_layers_cross_check mnist_cnn_bn steps: {worst} "
                                     f"differs by {step_err[worst]} of scale")
    xh = mnist_like(1024, 1024)[1][0]
    logits = {}
    for dev in ("cuda", "cpu"):
        sm = _json_model(CNN_BN_JSON, device=dev, mode="synchronous", frequency="batch",
                         num_workers=4)
        sm.fit(to_simple_rdd(SparkContext("local[4]"), x, y, num_slices=4), epochs=2,
               batch_size=64, validation_split=0.1)
        logits[dev] = sm.predict(xh)
    prob = {k: torch.softmax(torch.from_numpy(v).double(), -1).numpy()
            for k, v in logits.items()}
    top2 = np.sort(logits["cpu"], axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    agree = logits["cuda"].argmax(1) == logits["cpu"].argmax(1)
    held_out = {"rows": len(xh), "max_prob_diff": float(np.abs(prob["cuda"] - prob["cpu"]).max()),
                "max_logit_diff": float(np.abs(logits["cuda"] - logits["cpu"]).max()),
                "rows_past_margin": int(clear.sum()),
                "argmax_agreement_past_margin": float(agree[clear].mean()),
                "argmax_agreement_all": float(agree.mean()), "margin": 1e-3}
    emit({"phase": "fit_layers_cross_check", "workers": 4, "epochs": 2, "checks": checks,
          "bn_steps": {"max_err_rel_to_scale": step_err[worst], "worst": worst, "tol": 1e-4,
                       "compared": len(step_err),
                       "adam_updated_err_rel_to_scale": {
                           k: rel(gpu_adam[k], cpu_adam[k]) for k in cpu_adam}},
          "bn_grad_sync_held_out": held_out, "card": card})


# -- phases 50 to 53: Functional graphs, remat, the recurrent layers and options ----

# keras.applications.ResNet50(weights=None, input_shape=(32, 32, 3), classes=10,
# classifier_activation=None) compiled with SGD and cross-entropy from logits
# (examples/resnet50_spark.py's model at its published widths and depth, with a
# logits head so the fit reaches K1; its 224x224 ImageNet input cut to 32x32
# and its 1000 classes to 10); examples/ml_pipeline_imdb_lstm.py's model with a
# GRU and Embedding(mask_zero=True); an MNIST-shaped CNN through the small
# options (groups, channels_first, BatchNormalization on axis 1, a frozen one,
# Dropout(noise_shape)). The committed JSON of each, written once with Keras.
# The one-worker ResNet-50 fits run 1024 images (64 steps an epoch): a step is
# host-bound (~100-200 ms in the whole script), and four fits of 2048 took
# 85-115 s of the script's limit; the four-worker fits keep 2048 (32 steps an
# epoch a worker: at 16 their loss did not fall over 2 epochs).
RESNET_JSON = "elephas_tpu_torch/configs/resnet50_logits.json"
GRU_JSON = "elephas_tpu_torch/configs/imdb_gru_masked.json"
OPTIONS_JSON = "elephas_tpu_torch/configs/mnist_cnn_options.json"
RESNET_FIT = dict(fits=((1, 1024), (4, 2048)), batch=16, epochs=2, profiled_rows=64)
RECURRENT_FIT = dict(samples=4096, batch=32, workers=4, epochs=2, vocab=2000, maxlen=80)
OPTIONS_FIT = dict(samples=8192, batch=64, workers=4, epochs=2)


def cifar_like(n: int, seed: int = 0):
    """Uniform 32x32x3 images, labelled by which of 10 fixed random
    projections of the image is largest (one-hot)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, 32, 32, 3)).astype(np.float32)
    proj = np.random.default_rng(SEED + 50).normal(size=(32 * 32 * 3, 10)).astype(np.float32)
    return x, np.eye(10, dtype=np.float32)[(x.reshape(n, -1) @ proj).argmax(1)]


def padded_ids(n: int, vocab: int, maxlen: int, seed: int = 0):
    """Sequences of random lengths in [maxlen / 4, maxlen], right-padded with
    zeros (the masked steps), labelled 1 where their mean id is under
    ``vocab / 2``; float64, as the example feeds its ids."""
    rng = np.random.default_rng(seed)
    x = rng.integers(1, vocab, size=(n, maxlen))
    lengths = rng.integers(maxlen // 4, maxlen + 1, size=n)
    x[np.arange(maxlen)[None, :] >= lengths[:, None]] = 0
    y = (np.where(x > 0, x, 0).sum(1) / lengths < vocab / 2).astype(np.float32)[:, None]
    return x.astype(np.float64), y


def _weights_within(what, got, want, tol=1e-4):
    """Each array of ``got`` within ``tol`` of the largest entry of its
    ``want``; a failure names the array, the count of elements past the
    pin and the worst element's two values. The per-array errors."""
    errs = [float(np.abs(a - b).max()) / float(np.abs(b).max() or 1.0)
            for a, b in zip(got, want)]
    if errs and max(errs) > tol:
        i = int(np.argmax(errs))
        a, b = got[i], want[i]
        d = np.abs(a - b)
        j = np.unravel_index(d.argmax(), d.shape)
        require(False, f"{what}: weights differ by {errs[i]} of scale: array {i} {a.shape}, "
                       f"{int((d > tol * np.abs(b).max()).sum())} elements over the pin, "
                       f"the worst at {j}: {a[j]} vs {b[j]}")
    return errs


def _k1_at(shapes):
    """K1-fwd and K1-bwd timed at the fit's ``[B, 10]`` shapes (float32,
    one-hot rows) beside their plain versions and ``F.cross_entropy``, with
    the bound: ``{row name: [{shape, ms, plain_ms, library_ms, bound_ms,
    bound_by, max_abs_err}]}``."""
    from elephas_tpu_torch.ops.fused_xent import (fused_xent_bwd, fused_xent_bwd_reference,
                                                  fused_xent_fwd, fused_xent_fwd_reference)

    F = torch.nn.functional
    gen = np.random.default_rng(SEED + 51)
    out = {"fused_xent_fwd": [], "fused_xent_bwd": []}
    for B in shapes:
        sets = [_xent_inputs(gen, B, 10, torch.float32) for _ in range(8)]
        x, y, g = sets[0]
        err_f = float((fused_xent_fwd(x, y) - fused_xent_fwd_reference(x, y)).abs().max())
        err_b = float((fused_xent_bwd(x, y, g) - fused_xent_bwd_reference(x, y, g)).abs().max())
        require(err_f <= 1e-5 and err_b <= 1e-6, f"K1 at [{B}, 10]: errors {err_f}, {err_b}")
        graphs = []
        for xi, yi, gi in sets:
            xl = xi.detach().requires_grad_()
            graphs.append((F.cross_entropy(xl, yi, reduction="none"), xl, gi))
        for name, fn, plain, lib, inputs, n_bytes, n_ops, err in (
                ("fused_xent_fwd", lambda x, y, g: fused_xent_fwd(x, y),
                 lambda x, y, g: fused_xent_fwd_reference(x, y),
                 lambda x, y, g: F.cross_entropy(x, y, reduction="none"), sets,
                 B * 10 * 8 + 4 * B, 5 * B * 10, err_f),
                ("fused_xent_bwd", fused_xent_bwd, fused_xent_bwd_reference,
                 lambda o, xl, gi: torch.autograd.grad(o, xl, gi, retain_graph=True), graphs,
                 B * 10 * 12 + 4 * B, 6 * B * 10, err_b)):
            bms, by = bound_ms(n_bytes, n_ops)
            out[name].append({"shape": [B, 10], "ms": device_ms(fn, sets, 200),
                              "plain_ms": device_ms(plain, sets, 200),
                              "library_ms": device_ms(lib, inputs, 200), "bound_ms": bms,
                              "bound_by": by, "max_abs_err": err})
    return out


def fit_resnet(card):
    """The committed ResNet-50 through ``SparkModel(json, mode="synchronous",
    remat=...)`` at 1 worker (``examples/resnet50_spark.py`` on one card)
    and at 4, each without and with ``remat``: 1024 images at 1 worker and
    2048 at 4, batch 16, epoch frequency, 2 epochs, no validation. Finite, falling losses; exactly E S
    K1-bwd and E S K1-fwd launches, E 2S under remat (the recompute runs
    the loss again), no other kernel; ms a step, samples/s and
    ``torch.cuda.max_memory_allocated`` (reset before each fit, read
    against what was allocated before it) of each;
    one profiled epoch of the example's configuration (1 worker, remat)
    over 64 rows (the profiler's processing of ~5,000 launches a step is
    what takes time); K1 timed at the fits' [16 W, 10]."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = RESNET_FIT
    x, y = cifar_like(max(n for _, n in c["fits"]))
    E, B = c["epochs"], c["batch"]
    # warm-up: cuDNN's handles and each layer's first launches, at both widths
    for W, _ in c["fits"]:
        sm = _json_model(RESNET_JSON, mode="synchronous", num_workers=W)
        sm.fit(to_simple_rdd(SparkContext(f"local[{W}]"), x[:2 * B * W], y[:2 * B * W],
                             num_slices=W), epochs=1, batch_size=B, validation_split=0.0)
    runs, main_counts = [], None
    for W, n in c["fits"]:
        rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x[:n], y[:n], num_slices=W)
        S, Sv = _mlp_steps(n, W, B, 0.0)
        for remat in (False, True):
            sm = _json_model(RESNET_JSON, mode="synchronous", frequency="epoch",
                             parameter_server_mode="jax", num_workers=W, remat=remat)
            # what earlier phases left in reference cycles would be freed
            # mid-fit and move the baseline the peak is read against
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            wall, counts, hist = _compiled_fit(f"fit_resnet W{W} remat={remat}", sm, rdd, E,
                                               B, 0.0, S, Sv, remat=remat)
            peak = torch.cuda.max_memory_allocated()
            if W == 1 and not remat:
                main_counts = counts
            run = {"workers": W, "samples": n, "remat": remat, "steps_per_epoch": S,
                   "fit_s": wall, "ms_per_step": wall * 1e3 / (E * S),
                   "samples_per_s": W * (n // W) * E / wall, "history": hist,
                   "launches": {k: v for k, v in counts.items() if v},
                   "allocated_before_bytes": before, "max_allocated_bytes": peak,
                   "fit_peak_bytes": peak - before}
            if W == 1 and remat:
                rows = c["profiled_rows"]
                part = to_simple_rdd(SparkContext("local[1]"), x[:rows], y[:rows], num_slices=1)
                run["profiled_fit_1_epoch"] = profiled(
                    lambda: sm.fit(part, epochs=1, batch_size=B, validation_split=0.0), 1,
                    top_n=10)
                run["profiled_fit_1_epoch"]["steps"] = rows // B
            runs.append(run)
            del sm
            torch.cuda.empty_cache()
    peaks = {f"W{r['workers']}_remat_{r['remat']}": r["fit_peak_bytes"] for r in runs}
    shapes = _k1_at([B * W for W, _ in c["fits"]])
    emit({"phase": "fit_resnet", "config": RESNET_JSON, "batch": B, "epochs": E,
          "profiled_rows": c["profiled_rows"], "fits": runs, "fit_peak_bytes": peaks,
          "k1_at_fit_shapes": shapes, "card": card})
    return main_counts, shapes, runs


def _resnet_weights(seed: int):
    """The config's initial weights (the adapter's seed 0) with every 1-D
    array drawn anew from ``seed``: biases in [-0.1, 0.1], BatchNormalization
    gammas and variances in [0.5, 1.5], betas and means in [-0.1, 0.1]. (A
    convolution's bias before a BatchNormalization has a zero gradient, so
    left at zero it would hold only rounding after a step, and 1e-4 of its
    scale would pin rounding.)"""
    from elephas_tpu_torch.models import KerasModelAdapter

    with open(RESNET_JSON) as f:
        ws = KerasModelAdapter(f.read(), device="cpu").get_weights()
    rng = np.random.default_rng(seed)
    return [w if w.ndim != 1 else
            (rng.uniform(0.5, 1.5, w.shape) if np.all(w == 1.0)
             else rng.uniform(-0.1, 0.1, w.shape)).astype(np.float32) for w in ws]


def _resnet_step64(text, w, x, y):
    """One SGD step of the ResNet-50 config in float64 on the CPU from the
    weights ``w`` over the rows ``x``, ``y`` (the train step's arithmetic,
    the loss's softmax in float32 as the plain K1 computes it): the
    weights after it, in ``get_weights()`` order."""
    from elephas_tpu_torch.models import KerasModelAdapter

    a = KerasModelAdapter(text, device="cpu")
    part = {True: {}, False: {}}
    for spec, arr in zip(a._specs, w):
        part[spec.trainable][spec.name] = torch.from_numpy(np.asarray(arr, np.float64))[None]
    opt = a.make_optimizer()
    tv, ntv = part[True], part[False]
    tv2, ntv2, _, _ = a.build_train_step(opt)(
        tv, ntv, opt.init(tv, count_shape=(1,)), torch.from_numpy(x.astype(np.float64))[None],
        torch.from_numpy(y.astype(np.float64))[None], torch.ones(1, len(x), dtype=torch.float64),
        None)
    return [(tv2 if s.trainable else ntv2)[s.name][0].numpy() for s in a._specs]


def fit_resnet_cross_check(card):
    """Two steps of the ResNet-50 fit (1 worker, batch 16: a one-batch
    epoch of the engine's ``CompiledTrainer.fit`` a step), each from the
    same weights and rows on every side (the CPU's weights after the step
    before; the first from :func:`_resnet_weights`). Remat against plain on
    the card: every array within 1e-4 of its scale. The card against
    ``device="cpu"``: the loss within rtol 1e-4, the moved statistics and
    the head's kernel and bias (which the forward's values decide) within
    1e-4 of their scale, and every array's distance to the same step in
    float64 at most 4 times the CPU float32 step's largest. (A step's
    other arrays are not continuous in its inputs at float32's rounding: a
    ReLU or a max-pool whose input lies within rounding of its kink routes
    a whole unit's gradient, and in the last stage a kernel's gradient
    sums only 16 positions, so two float32 steps that sum in other orders
    part by percents of an array's scale, as each parts from the float64
    step; a second step from weights that differ so amplifies it again.)"""
    from elephas_tpu_torch.models import KerasModelAdapter
    from elephas_tpu_torch.parallel import CompiledTrainer

    x, y = cifar_like(32, seed=1)
    w = _resnet_weights(SEED + 52)
    with open(RESNET_JSON) as f:
        text = f.read()
    sides = {(dev, remat): CompiledTrainer(KerasModelAdapter(text, device=dev),
                                           mode="synchronous", remat=remat)
             for dev, remat in (("cuda", False), ("cuda", True), ("cpu", False))}
    specs = sides[("cpu", False)].adapter._specs
    smooth = [i for i, sp in enumerate(specs)
              if not sp.trainable or sp.name.startswith("predictions/")]
    checks = []
    for step in range(2):
        rows = slice(16 * step, 16 * (step + 1))
        out = {}
        for key, trainer in sides.items():
            trainer.adapter.set_weights(w)
            res = trainer.fit([(x[rows], y[rows])], epochs=1, batch_size=16)
            out[key] = (res.history["loss"][0], res.weights)
        oracle = _resnet_step64(text, w, x[rows], y[rows])
        gpu, remat, cpu = out[("cuda", False)], out[("cuda", True)], out[("cpu", False)]
        what = f"fit_resnet_cross_check step {step + 1}"
        remat_errs = _weights_within(f"{what}: card remat vs plain", remat[1], gpu[1])
        loss_rel = abs(gpu[0] - cpu[0]) / abs(cpu[0])
        require(loss_rel <= 1e-4, f"{what}: loss {gpu[0]} (card) vs {cpu[0]} (CPU)")
        smooth_errs = _weights_within(f"{what}: card vs CPU, statistics and head",
                                      [gpu[1][i] for i in smooth], [cpu[1][i] for i in smooth])

        def to_oracle(ws):
            return [float(np.abs(a - o).max()) / float(np.abs(o).max() or 1.0)
                    for a, o in zip(ws, oracle)]

        card_o, cpu_o = to_oracle(gpu[1]), to_oracle(cpu[1])
        i = int(np.argmax(card_o))
        require(card_o[i] <= 4 * max(cpu_o),
                f"{what}: the card's step lies {card_o[i]} of scale from the float64 step "
                f"({specs[i].name}), the CPU's at most {max(cpu_o)}")
        checks.append({"step": step + 1, "loss_card": gpu[0], "loss_cpu": cpu[0],
                       "loss_rel_err": loss_rel, "remat_vs_plain_err": max(remat_errs),
                       "stats_and_head_err": max(smooth_errs),
                       "card_to_float64_err": card_o[i], "card_worst": specs[i].name,
                       "cpu_to_float64_err": max(cpu_o),
                       "card_vs_cpu_err": max(float(np.abs(p - q).max()) /
                                              float(np.abs(q).max() or 1.0)
                                              for p, q in zip(gpu[1], cpu[1])),
                       "tol": 1e-4})
        w = cpu[1]
    emit({"phase": "fit_resnet_cross_check", "steps": 2, "batch": 16, "checks": checks,
          "card": card})


def _layers_cross_check(what, path, x, y, W, B, **kw):
    """A 2-epoch synchronous fit of the committed JSON on the card and on
    ``device="cpu"`` from the same weights and order: histories within
    rtol 1e-4, every array within 1e-4 of its scale."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    out = {}
    for dev in ("cuda", "cpu"):
        with open(path) as f:
            cfg = json.load(f)
        for layer in cfg["config"]["layers"]:       # the devices draw other masks
            if layer["class_name"] == "Dropout":
                layer["config"]["rate"] = 0.0
        sm = SparkModel(json.dumps(cfg), device=dev, mode="synchronous", num_workers=W, **kw)
        sm.fit(to_simple_rdd(SparkContext(f"local[{W}]"), x, y, num_slices=W), epochs=2,
               batch_size=B, validation_split=0.1)
        out[dev] = (sm.training_histories[-1], sm.master_network.get_weights())
    hist_err = max(abs(a - b) / max(abs(b), 1e-6) for k in out["cpu"][0]
                   for a, b in zip(out["cuda"][0][k], out["cpu"][0][k]))
    require(hist_err <= 1e-4, f"{what}: histories differ by {hist_err}: {out['cuda'][0]} "
                              f"vs {out['cpu'][0]}")
    errs = _weights_within(what, out["cuda"][1], out["cpu"][1])
    return {"workers": W, "epochs": 2, "samples": len(x), "history_rel_err": hist_err,
            "weight_err_rel_to_scale": max(errs), "tol": 1e-4,
            "history_gpu": out["cuda"][0], "history_cpu": out["cpu"][0]}


def fit_recurrent(card):
    """The masked GRU (the IMDB example's model with a GRU and
    ``mask_zero=True``) at full width through ``SparkModel.fit``: 4096
    right-padded sequences of lengths 20-80, batch 32, 4 workers,
    synchronous, 2 epochs. Falling loss; no kernel of the port launched (a
    sigmoid head); ms a step; then the card against the CPU (512
    sequences)."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = RECURRENT_FIT
    x, y = padded_ids(c["samples"], c["vocab"], c["maxlen"])
    W, E, B = c["workers"], c["epochs"], c["batch"]
    S, Sv = _mlp_steps(c["samples"], W, B, 0.0)
    sm = _json_model(GRU_JSON, mode="synchronous", num_workers=W)
    wall, counts, hist = _compiled_fit("fit_recurrent", sm,
                                       to_simple_rdd(SparkContext(f"local[{W}]"), x, y,
                                                     num_slices=W), E, B, 0.0, S, Sv, k1=False)
    xc, yc = padded_ids(512, c["vocab"], c["maxlen"], seed=1)
    check = _layers_cross_check("fit_recurrent cross-check", GRU_JSON, xc, yc, 4, B)
    dropout = _lstm_dropout_fit(c)
    emit({"phase": "fit_recurrent", "config": GRU_JSON, **c, "steps_per_epoch": S,
          "fit_s": wall, "ms_per_step": wall * 1e3 / (E * S),
          "samples_per_s": W * (c["samples"] // W) * E / wall, "history": hist,
          "cross_check": check, "lstm_dropout": dropout, "card": card})


def _lstm_dropout_fit(c, samples=2048, rate=0.2):
    """The IMDB LSTM (the committed config) with ``dropout`` and
    ``recurrent_dropout`` 0.2 (Keras's implementation 1: a mask a gate,
    fixed over the 80 steps): a 4-worker synchronous fit of 2 epochs on
    2048 sequences, batch 32, with a falling loss and no kernel; then its
    inference against the dropout-free config's forward from the same
    weights, within rtol 1e-5 (the per-gate projections sum in another
    grouping)."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.models import KerasModelAdapter
    from elephas_tpu_torch.utils import to_simple_rdd

    with open(LSTM_JSON) as f:
        plain = f.read()
    cfg = json.loads(plain)
    lstm = next(l for l in cfg["config"]["layers"] if l["class_name"] == "LSTM")
    lstm["config"].update(dropout=rate, recurrent_dropout=rate)
    text = json.dumps(cfg)
    x, y = imdb_like(samples, c["vocab"], c["maxlen"], seed=2)
    W, E, B = c["workers"], c["epochs"], c["batch"]
    S, Sv = _mlp_steps(samples, W, B, 0.0)
    sm = SparkModel(text, device="cuda", mode="synchronous", num_workers=W)
    require(sm.master_network.layers[1].per_gate, "fit_recurrent: the LSTM's dropout "
                                                  "does not run a mask a gate")
    wall, _, hist = _compiled_fit("fit_recurrent lstm dropout", sm,
                                  to_simple_rdd(SparkContext(f"local[{W}]"), x, y,
                                                num_slices=W), E, B, 0.0, S, Sv, k1=False)
    weights = sm.master_network.get_weights()
    got = sm.master_network.predict(x[:256], batch_size=64)
    want = KerasModelAdapter(plain, weights=weights, device="cuda").predict(x[:256],
                                                                           batch_size=64)
    err = float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-6))
    require(err <= 1e-5, f"fit_recurrent lstm dropout: inference differs from the "
                         f"dropout-free forward by {err} of scale")
    return {"config": LSTM_JSON, "dropout": rate, "recurrent_dropout": rate,
            "samples": samples, "steps_per_epoch": S, "fit_s": wall,
            "ms_per_step": wall * 1e3 / (E * S), "history": hist,
            "inference_rel_err": err}


def fit_options(card):
    """The options CNN (``mnist_cnn_options.json``) through
    ``SparkModel.fit``: 8192 MNIST-shaped samples, batch 64, 4 workers,
    synchronous, 2 epochs, no validation; exact K1 counts, falling loss, the
    frozen BatchNormalization's four arrays unchanged and the trainable
    one's statistics moved; then the card against the CPU (1024 samples,
    dropout off)."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = OPTIONS_FIT
    (x, y), _ = mnist_like(c["samples"], 0)
    W, E, B = c["workers"], c["epochs"], c["batch"]
    S, Sv = _mlp_steps(c["samples"], W, B, 0.0)
    sm = _json_model(OPTIONS_JSON, mode="synchronous", num_workers=W)
    frozen = [s.name for s in sm.master_network._specs if not s.trainable]
    before = {k: v.cpu() for k, v in sm.master_network.state_values()[1].items()}
    wall, counts, hist = _compiled_fit("fit_options", sm,
                                       to_simple_rdd(SparkContext(f"local[{W}]"), x, y,
                                                     num_slices=W), E, B, 0.0, S, Sv)
    after = {k: v.cpu() for k, v in sm.master_network.state_values()[1].items()}
    moved = sorted(k for k in after if not torch.equal(after[k], before[k]))
    require(len(frozen) == 6 and len(moved) == 2 and all(k in frozen[:2] for k in moved),
            f"fit_options: non-trainable {frozen}, moved {moved}")
    check = _layers_cross_check("fit_options cross-check", OPTIONS_JSON,
                                *mnist_like(1024, 0)[0], 4, B)
    emit({"phase": "fit_options", "config": OPTIONS_JSON, **c, "steps_per_epoch": S,
          "fit_s": wall, "ms_per_step": wall * 1e3 / (E * S),
          "samples_per_s": W * (c["samples"] // W) * E / wall, "history": hist,
          "launches": {k: v for k, v in counts.items() if v}, "moved": moved,
          "cross_check": check, "card": card})
    return counts


# -- phases 32a to 32e: mixed precision, Keras losses, metrics and fit options --

RESNET_MIXED_JSON = "elephas_tpu_torch/configs/resnet50_logits_mixed_bf16.json"
MLP_MIXED_JSON = "elephas_tpu_torch/configs/mnist_mlp_logits_mixed_f16.json"
# ResNet-50 under mixed_bfloat16 at fit_resnet's batch on 1024 images, 1 epoch,
# at 1 worker and at 4; the MLP under mixed_float16 at ml_mlp's batch, 4
# workers; the loss and metric fits at fit_options' scale
MIXED_FIT = dict(resnet_fits=((1, 1024), (4, 1024)), batch=16, epochs=1, profiled_rows=64,
                 mlp_samples=16384, mlp_batch=64, mlp_workers=4, mlp_epochs=2)
LOSSES_FIT = dict(samples=8192, batch=64, workers=4, epochs=2, eval_rows=1000,
                  host_samples=2048, host_batch=128, host_epochs=6)
BF16_PIN = 2e-2
K1_FP16_SHAPES = (("resnet_w1", 16, 10), ("mlp_w4", 256, 10), ("resnet_w4", 64, 10),
                  ("wide", 4096, 50257))


def check_fused_xent_fp16(card):
    """K1-fwd and K1-bwd on float16 logits (new in this slice) against their
    plain versions: the loss within atol = rtol = 1e-5 (float32 sums in
    another order), dx within one fp16 ulp of each element (rtol 2**-10,
    atol 2**-24, the subnormals' step: both round nearly the same float32
    value; at [4096, 50257] most of dx is subnormal), each run twice for the same bits,
    at the mixed fits' shapes ([16, 10] for ResNet-50 at one worker, [64,
    10] at four, [256, 10] for the MLP's four workers) and at [4096,
    50257]; timed beside the plain versions and ``F.cross_entropy`` on
    float16 logits and probability targets (and its autograd backward),
    with the bound in bytes: the forward reads 2 + 4 bytes an element and
    writes 4 a row, the backward reads 2 + 4 and writes 2 an element."""
    from elephas_tpu_torch.ops.fused_xent import (ROUTES, _vec_max, fused_xent_bwd,
                                                  fused_xent_bwd_reference, fused_xent_fwd,
                                                  fused_xent_fwd_reference, xent_plan)

    F = torch.nn.functional
    gen = np.random.default_rng(SEED + 60)
    f16 = torch.float16
    out, worst, rows = {"fwd": [], "bwd": []}, {"fwd": 0.0, "bwd": 0.0}, {}
    for name, B, C in K1_FP16_SHAPES:
        sets = [_xent_inputs(gen, B, C, f16)]
        sets += [_xent_inputs(gen, B, C, f16)
                 for _ in range(l2_sets(sum(t.nbytes for t in sets[0])) - 1)]
        lib_sets = [(xi, yi.to(f16), gi) for xi, yi, gi in sets]
        x, y, g = sets[0]
        plan = xent_plan(C, 2, _vec_max(x, y))
        fwd, bwd = fused_xent_fwd(x, y), fused_xent_bwd(x, y, g)
        same = torch.equal(fwd, fused_xent_fwd(x, y)) and \
            torch.equal(bwd, fused_xent_bwd(x, y, g))
        require(bwd.dtype == f16 and fwd.dtype == torch.float32,
                f"fused_xent fp16 {name}: dtypes {fwd.dtype}, {bwd.dtype}")
        err_f, ok_f = _allclose_err(fwd, fused_xent_fwd_reference(x, y), 1e-5)
        want_b = fused_xent_bwd_reference(x, y, g).double()
        diff_b = (bwd.double() - want_b).abs()
        err_b = float(diff_b.max())
        ok_b = bool((diff_b <= 2.0 ** -24 + 2.0 ** -10 * want_b.abs()).all())
        require(bool(torch.isfinite(fwd).all() and torch.isfinite(bwd.float()).all()),
                f"fused_xent fp16 {name}: not finite")
        require(ok_f and float(fwd[0]) == 0.0,
                f"fused_xent_fwd fp16 {name}: max abs err {err_f} beyond 1e-5")
        require(ok_b, f"fused_xent_bwd fp16 {name}: max abs err {err_b}, an element "
                      f"beyond one fp16 ulp (2**-24 + 2**-10 |dx|)")
        require(same, f"fused_xent fp16 {name}: a second run gave other bits")
        worst["fwd"], worst["bwd"] = max(worst["fwd"], err_f), max(worst["bwd"], err_b)
        n_iter = 200 if B * C < 1e6 else 20
        f_ms = device_ms(lambda x, y, g: fused_xent_fwd(x, y), sets, n_iter)
        f_plain = device_ms(lambda x, y, g: fused_xent_fwd_reference(x, y), sets, n_iter)
        f_lib = device_ms(lambda x, y, g: F.cross_entropy(x, y, reduction="none"), lib_sets,
                          n_iter)
        b_ms = device_ms(fused_xent_bwd, sets, n_iter)
        b_plain = device_ms(fused_xent_bwd_reference, sets, n_iter)
        graphs = []
        for xi, yi, gi in lib_sets:
            xl = xi.detach().requires_grad_()
            graphs.append((F.cross_entropy(xl, yi, reduction="none"), xl, gi))
        b_lib = device_ms(lambda o, xl, gi: torch.autograd.grad(o, xl, gi, retain_graph=True),
                          graphs, n_iter)
        del graphs
        fb, fby = bound_ms(B * C * (2 + 4) + 4 * B, 5 * B * C)
        bb, bby = bound_ms(B * C * (2 * 2 + 4) + 4 * B, 6 * B * C)
        route = {"route": ROUTES[plan[0]], "vec": plan[1], "cluster": plan[2],
                 "slice": plan[3], "sets": len(sets)}
        for kind, ms, plain, lib, bms, by, err in (
                ("fwd", f_ms, f_plain, f_lib, fb, fby, err_f),
                ("bwd", b_ms, b_plain, b_lib, bb, bby, err_b)):
            out[kind].append({"case": name, "shape": [B, C], "dtype": "float16", **route,
                              "max_abs_err": err, "same_bits": same, "ms": ms,
                              "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
                              "bound_by": by, "bound_share": bms / ms})
            if name == "mlp_w4":
                rows[kind] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                              "bound_ms": bms, "bound_by": by}
        del sets, lib_sets, x, y, g, fwd, bwd
        torch.cuda.empty_cache()
    emit({"phase": "kernel", "kernel": "fused_xent_fp16", "fwd": out["fwd"],
          "bwd": out["bwd"], "card": card})
    lines = {"fwd": ("fused_xent_fwd", "elephas_tpu/ops/pallas_ops.py:99",
                     "F.cross_entropy(x, y, reduction='none') on float16 logits and "
                     "probability targets"),
             "bwd": ("fused_xent_bwd", "elephas_tpu/ops/pallas_ops.py:113",
                     "autograd backward of that F.cross_entropy")}
    return [{"name": lines[k][0] + "_fp16", "counter": lines[k][0], "route": "cuda",
             "source": "elephas_tpu_torch/ops/csrc/fused_xent.cu", "replaces": lines[k][1],
             "max_abs_err": worst[k], **rows[k], "library": lines[k][2],
             "timed_shape": [256, 10], "logits_dtype": "float16",
             "shapes": out[k]} for k in ("fwd", "bwd")]


class _K1Dtypes:
    """Inside a ``with``: the logits dtype of every K1 launch, by wrapper
    (``fused_xent_fwd`` / ``fused_xent_bwd``), counted as the wrapper counts
    its launches (``_launch`` is where it launches)."""

    def __enter__(self):
        from elephas_tpu_torch.ops import fused_xent as X

        self.X, self.real, self.seen = X, X._launch, {}

        def launch(entry, x, *args, **kw):
            key = (entry, str(x.dtype).removeprefix("torch."))
            self.seen[key] = self.seen.get(key, 0) + 1
            return self.real(entry, x, *args, **kw)

        X._launch = launch
        return self

    def __exit__(self, *exc):
        self.X._launch = self.real

    def by_dtype(self):
        return {f"{e}:{d}": n for (e, d), n in sorted(self.seen.items())}


def _mixed_fit(what, sm, rdd, E, B, S, dtype, falls=True):
    """A compiled fit with the counters set to 0 just before and read just
    after: finite losses (falling, with ``falls``), exactly E S launches of
    each K1 wrapper, every one on ``dtype`` logits, no other kernel;
    ``(wall s, counts, history, dtypes, peak bytes over the start)``."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters()
    with _K1Dtypes() as seen:
        t0 = time.perf_counter()
        sm.fit(rdd, epochs=E, batch_size=B, validation_split=0.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _read_counters()
    peak = torch.cuda.max_memory_allocated() - before
    hist = sm.training_histories[-1]
    require(all(np.isfinite(v).all() for v in hist.values()), f"{what}: non-finite {hist}")
    if falls:
        require(hist["loss"][-1] < hist["loss"][0], f"{what}: loss did not fall: {hist}")
    for name in ("fused_xent_fwd", "fused_xent_bwd"):
        require(counts[name] == E * S, f"{what}: {name} launched {counts[name]} times, "
                                       f"want {E * S} (E {E}, S {S})")
    want = {f"fused_xent_fwd:{dtype}": E * S, f"fused_xent_bwd:{dtype}": E * S}
    require(seen.by_dtype() == want, f"{what}: K1 launches by dtype {seen.by_dtype()}, "
                                     f"want {want}")
    others = {k: v for k, v in counts.items() if not k.startswith("fused_xent") and v}
    require(not others, f"{what}: other kernels launched: {others}")
    return wall, counts, hist, seen.by_dtype(), peak


def _per_epoch_loss(sm, rdd, E, B):
    """The losses of E one-epoch fits, each from where the last left off."""
    out = []
    for _ in range(E):
        sm.fit(rdd, epochs=1, batch_size=B, validation_split=0.0)
        out.append(sm.training_histories[-1]["loss"][0])
    return out


def _mlp_mixed_text(dropout=True):
    with open(MLP_MIXED_JSON) as f:
        cfg = json.load(f)
    if not dropout:
        for layer in cfg["config"]["layers"]:
            if layer["class_name"] == "Dropout":
                layer["config"]["rate"] = 0.0
    return json.dumps(cfg)


def fit_mixed(card, resnet_f32_runs):
    """ResNet-50 under ``mixed_bfloat16`` (the committed config) through
    ``SparkModel(json, mode="synchronous")``: batch 16, 1 epoch on 1024
    images at 1 worker and at 4; then the MNIST MLP under ``mixed_float16``
    at 4 workers, batch 64, 2 epochs on 16384 samples (its compiled path
    runs the reference's SGD fall-back at 0.001 without loss scaling, since
    Keras wraps its Adam in a LossScaleOptimizer: its loss falls slowly and
    is judged against the CPU in ``fit_mixed_cross_check``). Each: finite
    losses, falling for ResNet-50; exactly E S K1 launches each way, every
    one on bf16 (fp16) logits; no other kernel; ms a step, samples/s and
    the fit's peak memory beside ``fit_resnet``'s float32 figures; one
    profiled epoch of 64 rows at 1 worker of the bf16 config and of the
    float32 one (device ms a step, busy share, the kernels that take the
    most)."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = MIXED_FIT
    x, y = cifar_like(max(n for _, n in c["resnet_fits"]))
    E, B = c["epochs"], c["batch"]
    f32 = {r["workers"]: r for r in resnet_f32_runs if not r["remat"]}
    for W, _ in c["resnet_fits"]:                   # warm-up at each width
        sm = _json_model(RESNET_MIXED_JSON, mode="synchronous", num_workers=W)
        sm.fit(to_simple_rdd(SparkContext(f"local[{W}]"), x[:2 * B * W], y[:2 * B * W],
                             num_slices=W), epochs=1, batch_size=B, validation_split=0.0)
    runs, counts_main = [], None
    for W, n in c["resnet_fits"]:
        rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x[:n], y[:n], num_slices=W)
        S, _ = _mlp_steps(n, W, B, 0.0)
        sm = _json_model(RESNET_MIXED_JSON, mode="synchronous", frequency="epoch",
                         parameter_server_mode="jax", num_workers=W)
        require(sm.master_network.layers[1].dtype == torch.bfloat16,
                "fit_mixed: the ResNet's convolutions do not compute in bf16")
        wall, counts, hist, dtypes, peak = _mixed_fit(
            f"fit_mixed resnet50 W{W}", sm, rdd, E, B, S, "bfloat16", falls=False)
        hist = dict(hist)
        if W == 1:
            counts_main = counts
        ms = wall * 1e3 / (E * S)
        ref = f32.get(W, {})
        runs.append({"model": "resnet50_mixed_bfloat16", "workers": W, "samples": n,
                     "steps_per_epoch": S, "fit_s": wall, "ms_per_step": ms,
                     "samples_per_s": W * (n // W) * E / wall, "history": hist,
                     "k1_by_dtype": dtypes, "fit_peak_bytes": peak,
                     "float32_ms_per_step": ref.get("ms_per_step"),
                     "float32_fit_peak_bytes": ref.get("fit_peak_bytes"),
                     "bf16_over_f32_step": ms / ref["ms_per_step"] if ref else None})
        # a second epoch from the fitted weights: at 1 worker (plain SGD) its
        # loss falls below the first's; at 4 (16 steps a replica between
        # merges) the float32 config runs the same two epochs beside it
        before = hist["loss"][0]
        after = _per_epoch_loss(sm, rdd, 1, B)[0]
        require(np.isfinite(after) and (W > 1 or after < before),
                f"fit_mixed resnet50 W{W}: loss {before} then {after}")
        runs[-1]["second_epoch_loss"] = after
        del sm
        torch.cuda.empty_cache()
        if W > 1:
            f32_sm = _json_model(RESNET_JSON, mode="synchronous", frequency="epoch",
                                 parameter_server_mode="jax", num_workers=W)
            runs[-1]["float32_same_schedule_losses"] = _per_epoch_loss(f32_sm, rdd, 2, B)
            del f32_sm
            torch.cuda.empty_cache()
    # where a step's time goes: one epoch over 64 rows at 1 worker under the
    # profiler, the bf16 config and the float32 one in the same process
    rows = c["profiled_rows"]
    part = to_simple_rdd(SparkContext("local[1]"), x[:rows], y[:rows], num_slices=1)
    profiles = {}
    for label, path in (("mixed_bfloat16", RESNET_MIXED_JSON), ("float32", RESNET_JSON)):
        psm = _json_model(path, mode="synchronous", frequency="epoch",
                          parameter_server_mode="jax", num_workers=1)
        psm.fit(part, epochs=1, batch_size=B, validation_split=0.0)
        prof = profiled(lambda: psm.fit(part, epochs=1, batch_size=B, validation_split=0.0),
                        1, top_n=8)
        steps = rows // B
        profiles[label] = {**prof, "steps": steps,
                           "wall_ms_per_train_step": prof["wall_ms_per_step"] / steps,
                           "device_ms_per_train_step": prof["device_ms_per_step"] / steps}
        del psm
        torch.cuda.empty_cache()
    (xm, ym), _ = mnist_like(c["mlp_samples"], 0)
    W, Bm, Em = c["mlp_workers"], c["mlp_batch"], c["mlp_epochs"]
    S, _ = _mlp_steps(c["mlp_samples"], W, Bm, 0.0)
    rdd = to_simple_rdd(SparkContext(f"local[{W}]"), xm, ym, num_slices=W)
    warm = SparkModel(_mlp_mixed_text(), device="cuda", mode="synchronous", num_workers=W)
    warm.fit(to_simple_rdd(SparkContext(f"local[{W}]"), xm[:2 * Bm * W], ym[:2 * Bm * W],
                           num_slices=W), epochs=1, batch_size=Bm, validation_split=0.0)
    sm = SparkModel(_mlp_mixed_text(), device="cuda", mode="synchronous", num_workers=W)
    spec = sm.master_network.optimizer_spec
    require(isinstance(spec, dict) and spec["class_name"] == "LossScaleOptimizer",
            f"fit_mixed: the mixed_float16 MLP's optimizer {spec}")
    wall, mlp_counts, hist, dtypes, peak = _mixed_fit(
        "fit_mixed mlp", sm, rdd, Em, Bm, S, "float16", falls=False)
    runs.append({"model": "mnist_mlp_mixed_float16", "workers": W,
                 "samples": c["mlp_samples"], "steps_per_epoch": S, "fit_s": wall,
                 "ms_per_step": wall * 1e3 / (Em * S),
                 "samples_per_s": c["mlp_samples"] * Em / wall, "history": dict(hist),
                 "k1_by_dtype": dtypes, "fit_peak_bytes": peak,
                 "optimizer": "SGD(lr=0.001), the reference's fall-back"})
    emit({"phase": "fit_mixed", **c, "fits": runs, "profiled_fit_1_epoch": profiles,
          "card": card})
    return counts_main, mlp_counts


def fit_mixed_cross_check(card):
    """The card against ``device="cpu"`` from the same weights and order.
    ResNet-50 under ``mixed_bfloat16``, one synchronous step at batch 16
    from the config's initial weights (the adapter's seed 0; with every 1-D
    array drawn wide, as :func:`_resnet_weights` draws them, the bf16
    forward's loss parts by 11% between an H100 and the CPU), beside the
    float32 config's step on the CPU and its float64 step
    (:func:`_resnet_step64`): the loss within the bf16 pin 2e-2, and each
    array's update (the weights after the step less before) checked by
    what bf16 keeps of it. Arrays whose float64 update is under float32's
    resolution of the step's largest (2**-23 of it: the convolutions'
    biases before a BatchNormalization, whose exact gradient is 0) are
    left out. The moved statistics, which the forward decides: the card's
    update no farther from the CPU's bf16 update (relative L2) than 4
    times the CPU's from its float32 update. The trainable arrays: a bf16
    step's direction is rounding's at these weights (the CPU's bf16 update
    lies about 1.3 of its norm from the float32 one, median over the
    arrays, as far as two unrelated vectors), so each update's norm is
    held instead: its log ratio to the CPU's bf16 norm within twice the
    largest the CPU's bf16 and float32 norms part by (two bf16 steps part
    by up to about 1.4 times one's distance from float32; a step skipped,
    halved or doubled fails). The ``mixed_float16`` MLP (dropout off), 2
    workers, 2 epochs on 2048 samples from the same weights: histories
    within 2e-2, each array's update within 2e-2 of the CPU update's
    scale. A failure names the array and its figures (for the MLP, the
    count of elements past the pin and the worst element's two values)."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.models import KerasModelAdapter
    from elephas_tpu_torch.parallel import CompiledTrainer
    from elephas_tpu_torch.utils import to_simple_rdd

    x, y = cifar_like(16, seed=3)
    with open(RESNET_JSON) as f:
        text32 = f.read()
    w = KerasModelAdapter(text32, device="cpu").get_weights()
    out = {}
    for key, path, dev in (("cuda", RESNET_MIXED_JSON, "cuda"),
                           ("cpu", RESNET_MIXED_JSON, "cpu"), ("cpu_f32", RESNET_JSON, "cpu")):
        with open(path) as f:
            adapter = KerasModelAdapter(f.read(), weights=w, device=dev)
        res = CompiledTrainer(adapter, mode="synchronous").fit([(x, y)], epochs=1,
                                                               batch_size=16)
        out[key] = (res.history["loss"][0],
                    [np.asarray(a, np.float64) - w0 for a, w0 in zip(res.weights, w)])
    specs = adapter._specs
    u64 = [np.asarray(a, np.float64) - w0 for a, w0 in zip(_resnet_step64(text32, w, x, y), w)]
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    require(loss_rel <= BF16_PIN, f"fit_mixed_cross_check resnet50: loss "
                                  f"{out['cuda'][0]} (card) vs {out['cpu'][0]} (CPU)")
    top = max(float(np.abs(u).max()) for u in u64)
    kept = [i for i, u in enumerate(u64) if float(np.abs(u).max()) >= 2.0 ** -23 * top]

    def rel_l2(a, b):
        return float(np.linalg.norm(a - b) / (np.linalg.norm(b) or 1.0))

    def log_norm(a, b):
        return float(np.log(np.linalg.norm(a) / np.linalg.norm(b)))

    card_u, cpu_u, f32_u = out["cuda"][1], out["cpu"][1], out["cpu_f32"][1]
    stats = [i for i in kept if not specs[i].trainable]
    trained = [i for i in kept if specs[i].trainable]
    stat_rows = [(rel_l2(card_u[i], cpu_u[i]), rel_l2(cpu_u[i], f32_u[i]), i) for i in stats]
    for card_d, cpu_d, i in stat_rows:
        require(card_d <= 4 * cpu_d,
                f"fit_mixed_cross_check resnet50: statistic {specs[i].name} "
                f"{card_u[i].shape}: the card's update lies {card_d} (relative L2) from "
                f"the CPU's bf16 update, which lies {cpu_d} from the float32 one")
    spread = max(abs(log_norm(cpu_u[i], f32_u[i])) for i in trained)
    norm_rows = [(abs(log_norm(card_u[i], cpu_u[i])), i) for i in trained]
    for card_d, i in norm_rows:
        require(card_d <= 2 * spread,
                f"fit_mixed_cross_check resnet50: array {specs[i].name} "
                f"{card_u[i].shape}: the card's update norm {np.linalg.norm(card_u[i])} vs "
                f"the CPU's bf16 {np.linalg.norm(cpu_u[i])} (log ratio {card_d}, the CPU's "
                f"bf16 and float32 norms part by at most {spread})")
    worst_stat = max(stat_rows, key=lambda r: r[0] / max(r[1], 1e-30))
    worst_norm = max(norm_rows)
    (xm, ym), _ = mnist_like(2048, 0)
    mlp, w0 = {}, None
    for dev in ("cuda", "cpu"):
        sm = SparkModel(_mlp_mixed_text(dropout=False), device=dev, mode="synchronous",
                        num_workers=2)
        if w0 is None:
            w0 = sm.master_network.get_weights()
        sm.master_network.set_weights(w0)
        sm.fit(to_simple_rdd(SparkContext("local[2]"), xm, ym, num_slices=2), epochs=2,
               batch_size=64, validation_split=0.1)
        mlp[dev] = (sm.training_histories[-1],
                    [np.asarray(a, np.float64) - b for a, b in
                     zip(sm.master_network.get_weights(), w0)])
    hist_err = max(abs(a - b) / max(abs(b), 1e-6) for k in mlp["cpu"][0]
                   for a, b in zip(mlp["cuda"][0][k], mlp["cpu"][0][k]))
    require(hist_err <= BF16_PIN, f"fit_mixed_cross_check mlp: histories differ by "
                                  f"{hist_err}: {mlp['cuda'][0]} vs {mlp['cpu'][0]}")
    m_errs = _weights_within("fit_mixed_cross_check mlp updates", mlp["cuda"][1],
                             mlp["cpu"][1], BF16_PIN)
    emit({"phase": "fit_mixed_cross_check", "tol": BF16_PIN,
          "resnet50": {"loss_card": out["cuda"][0], "loss_cpu": out["cpu"][0],
                       "loss_cpu_float32": out["cpu_f32"][0], "loss_rel_err": loss_rel,
                       "arrays_kept": len(kept), "arrays": len(specs),
                       "stats_card_to_cpu_l2_median": float(np.median([r[0] for r in stat_rows])),
                       "stats_cpu_to_float32_l2_median": float(np.median([r[1] for r in
                                                                          stat_rows])),
                       "stats_worst": {"name": specs[worst_stat[2]].name,
                                       "card_to_cpu_l2": worst_stat[0],
                                       "cpu_to_float32_l2": worst_stat[1]},
                       "trained_cpu_to_float32_l2_median": float(np.median(
                           [rel_l2(cpu_u[i], f32_u[i]) for i in trained])),
                       "trained_card_to_cpu_l2_median": float(np.median(
                           [rel_l2(card_u[i], cpu_u[i]) for i in trained])),
                       "norm_log_ratio_worst": {"name": specs[worst_norm[1]].name,
                                                "card_to_cpu": worst_norm[0],
                                                "cpu_to_float32_spread": spread}},
          "mlp": {"history_rel_err": hist_err, "update_err_rel_to_scale": max(m_errs),
                  "history_gpu": mlp["cuda"][0], "history_cpu": mlp["cpu"][0]},
          "card": card})


def _histories_within(what, got, want, rtol=1e-4, atol=1e-6):
    """Each history value within ``rtol`` of the CPU's plus ``atol`` (a
    loss that falls near 0 keeps float32's absolute rounding); the largest
    relative difference."""
    pairs = [(k, a, b) for k in want for a, b in zip(got[k], want[k])]
    bad = [(k, a, b) for k, a, b in pairs if abs(a - b) > rtol * abs(b) + atol]
    require(set(got) == set(want) and not bad,
            f"{what}: histories differ: {bad[:3]} ({sorted(got)} vs {sorted(want)})")
    return max(abs(a - b) / max(abs(b), 1e-6) for _, a, b in pairs)


class PatienceStop:
    """Keras's ``EarlyStopping(monitor, min_delta, patience)`` in mode
    "min", written against the callback protocol (the card has no Keras):
    ``stopped_epoch`` the epoch after which it stopped the fit."""

    def __init__(self, monitor="val_loss", min_delta=0.0, patience=0):
        self.monitor, self.min_delta, self.patience = monitor, abs(min_delta), patience
        self.model, self.stopped_epoch, self.epochs_seen = None, 0, []

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        self.best, self.wait, self.stopped_epoch = float("inf"), 0, 0

    def on_epoch_end(self, epoch, logs=None):
        value = logs.get(self.monitor)
        self.epochs_seen.append(epoch)
        if value is None:
            return
        if value + self.min_delta < self.best:       # a fall of more than min_delta
            self.best, self.wait = value, 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            self.stopped_epoch = epoch
            self.model.stop_training = True


def fit_losses_metrics(card):
    """The MLP (its head a softmax) through ``SparkModel``'s compiled path
    with the losses the reference hands to Keras, ``KLDivergence()`` (its
    serialized object: one scalar a replica's batch) and ``"poisson"`` (the
    function: per-sample values), 4 workers, batch 64, 2 epochs on 8192
    samples: no kernel (no cross-entropy), falling losses; ``evaluate``
    with ``["accuracy", "mae", "top_k_categorical_accuracy"]`` (Keras's
    fall-back, batches of 32, 1000 rows); a host-path fit (synchronous,
    ``comm="host"``, one worker) with ``class_weight``, a patience
    callback on ``val_loss`` and ``validation_freq=2`` (2048 samples, batch
    128, 6 epochs, stopped after the fourth): K1 E S forward and backward on
    the training batches and forward on the validations, the stop epoch.
    Each against ``device="cpu"`` from the same weights and order (dropout
    off): histories within rtol
    1e-4 plus 1e-6 (the host fit's loss falls to about 1e-3), evaluations
    within rtol 1e-4, the arrays within 1e-4 of their scale."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = LOSSES_FIT
    with open(MNIST_JSON) as f:
        cfg = json.load(f)
    for layer in cfg["config"]["layers"]:
        if layer["class_name"] == "Dropout":
            layer["config"]["rate"] = 0.0
    cfg["config"]["layers"][-1]["config"]["activation"] = "softmax"
    cfg["compile_config"]["metrics"] = ["accuracy", "mae", "top_k_categorical_accuracy"]
    text = json.dumps(cfg)
    (x, y), (xe, ye) = mnist_like(c["samples"], c["eval_rows"])
    W, B, E = c["workers"], c["batch"], c["epochs"]
    S, _ = _mlp_steps(c["samples"], W, B, 0.0)
    kld = {"module": "keras.losses", "class_name": "KLDivergence",
           "config": {"name": "kl_divergence", "reduction": "sum_over_batch_size"}}
    fits, evals = {}, {}
    for loss_name, loss in (("kl_divergence_object", kld), ("poisson", "poisson")):
        got = {}
        for dev in ("cuda", "cpu"):
            n = c["samples"] if dev == "cuda" else 1024
            sm = SparkModel(text, device=dev, mode="synchronous", num_workers=W,
                            master_loss=loss)
            rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x[:n], y[:n], num_slices=W)
            if dev == "cuda":
                wall, counts, hist = _compiled_fit(f"fit_losses_metrics {loss_name}", sm,
                                                   rdd, E, B, 0.0, S, 0, k1=False)
                fits[loss_name] = {"fit_s": wall, "ms_per_step": wall * 1e3 / (E * S),
                                   "history": hist}
                sm = SparkModel(text, device=dev, mode="synchronous", num_workers=W,
                                master_loss=loss)
                rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x[:1024], y[:1024],
                                    num_slices=W)
            sm.fit(rdd, epochs=E, batch_size=B, validation_split=0.0)
            got[dev] = (sm.training_histories[-1], sm.master_network.get_weights(),
                        sm.evaluate(xe, ye))
        hist_err = _histories_within(f"fit_losses_metrics {loss_name}", got["cuda"][0],
                                     got["cpu"][0])
        errs = _weights_within(f"fit_losses_metrics {loss_name}", got["cuda"][1],
                               got["cpu"][1])
        ev_card, ev_cpu = got["cuda"][2], got["cpu"][2]
        require(isinstance(ev_card, list) and len(ev_card) == 4,
                f"fit_losses_metrics {loss_name}: evaluate gave {ev_card}")
        ev_err = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(ev_card, ev_cpu))
        require(ev_err <= 1e-4, f"fit_losses_metrics {loss_name}: evaluate {ev_card} vs "
                                f"{ev_cpu}")
        fits[loss_name].update({"history_rel_err": hist_err,
                                "weight_err_rel_to_scale": max(errs)})
        evals[loss_name] = {"card": ev_card, "cpu": ev_cpu, "rel_err": ev_err,
                            "names": ["loss", "accuracy", "mae",
                                      "top_k_categorical_accuracy"]}
    cfg["config"]["layers"][-1]["config"]["activation"] = None
    cfg["compile_config"]["metrics"] = ["accuracy"]
    host_text = json.dumps(cfg)
    (xh, yh), _ = mnist_like(c["host_samples"], 0)
    Bh, Eh = c["host_batch"], c["host_epochs"]
    n_train = int(np.floor(c["host_samples"] * 0.9))
    Sh = -(-n_train // Bh)
    host = {}
    for dev in ("cuda", "cpu"):
        # val_loss at epochs 2 and 4: no gain of 1.0 at the second, so the
        # fit stops after its fourth epoch of six
        stop = PatienceStop("val_loss", min_delta=1.0, patience=1)
        sm = SparkModel(host_text, device=dev, mode="synchronous", comm="host",
                        num_workers=1, port=0, master_metrics=["accuracy", "mae"])
        np.random.seed(SEED + 61)
        if dev == "cuda":
            torch.cuda.synchronize()
            _zero_counters()
        t0 = time.perf_counter()
        sm.fit(to_simple_rdd(SparkContext("local[1]"), xh, yh, num_slices=1), epochs=Eh,
               batch_size=Bh, validation_split=0.1, class_weight={0: 2.0, 3: 0.5, 7: 1.5},
               callbacks=[stop], validation_freq=2)
        wall = time.perf_counter() - t0
        host[dev] = (sm.training_histories[-1], sm.master_network.get_weights(), stop,
                     _read_counters() if dev == "cuda" else None, wall)
    hist_c, w_c, stop_c, counts, wall = host["cuda"]
    hist_p, w_p, stop_p, _, _ = host["cpu"]
    ran = len(hist_c["loss"])
    require(stop_c.epochs_seen == stop_p.epochs_seen == [0, 1, 2, 3] and
            stop_c.stopped_epoch == 3 and ran == len(hist_p["loss"]),
            f"fit_losses_metrics host: epochs {stop_c.epochs_seen} (card) vs "
            f"{stop_p.epochs_seen} (CPU), stopped after {stop_c.stopped_epoch}")
    require(set(hist_c) == {"loss", "accuracy", "mae", "val_loss", "val_accuracy", "val_mae"}
            and len(hist_c["val_loss"]) == ran // 2,
            f"fit_losses_metrics host: history keys {sorted(hist_c)}")
    hist_err = _histories_within("fit_losses_metrics host", hist_c, hist_p)
    h_errs = _weights_within("fit_losses_metrics host", w_c, w_p)
    want = {"fused_xent_fwd": ran * Sh + (ran // 2) * -(-(c["host_samples"] - n_train) // Bh),
            "fused_xent_bwd": ran * Sh}
    for name, n in want.items():
        require(counts[name] == n, f"fit_losses_metrics host: {name} launched "
                                   f"{counts[name]} times, want {n}")
    others = {k: v for k, v in counts.items() if not k.startswith("fused_xent") and v}
    require(not others, f"fit_losses_metrics host: other kernels launched: {others}")
    emit({"phase": "fit_losses_metrics", **c, "compiled_fits": fits, "evaluate": evals,
          "host": {"epochs_run": ran, "stopped_epoch": stop_c.stopped_epoch,
                   "history_gpu": hist_c, "history_rel_err": hist_err,
                   "weight_err_rel_to_scale": max(h_errs), "fit_s": wall,
                   "launches": {k: v for k, v in counts.items() if v}},
          "card": card})
    return {"fit_losses_metrics_host": counts}


# -- phases 54 to 56: nested models, graph options, stateful metrics, ctc ---------

# Keras's transfer-learning recipe on examples/resnet50_spark.py's ResNet-50: the
# committed JSONs, written once with Keras from keras.applications.ResNet50(
# include_top=False, weights=None, input_shape=(32, 32, 3)) nested under
# GlobalAveragePooling2D and a Dense(10) logits head and called with
# training=False; the base frozen (SGD 0.01), then made trainable again (SGD
# 1e-5). Each stage as fit_resnet's one-worker float32 run: 1024 CIFAR-shaped
# images, batch 16, 2 epochs. The small models of configs/graph_options.json
# (widths 8 to 32, written once with Keras) for the graph options, the stateful
# metric classes and ctc: 1024 samples at 2 workers on the compiled path, 512 on
# the host path, batch 32, 2 epochs.
TRANSFER_JSON = "elephas_tpu_torch/configs/resnet50_transfer_logits.json"
FINETUNE_JSON = "elephas_tpu_torch/configs/resnet50_finetune_logits.json"
GRAPH_OPTIONS_JSON = "elephas_tpu_torch/configs/graph_options.json"
TRANSFER_FIT = dict(samples=1024, batch=16, epochs=2, profiled_rows=64, cross_rows=64)
GRAPH_FIT = dict(samples=1024, host_samples=512, batch=32, workers=2, epochs=2,
                 eval_rows=200)


def _fit_peak(fit):
    """``fit()`` with the peak of allocated memory read over what was
    allocated before it: ``(fit's result, peak bytes)``."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fit()
    return out, torch.cuda.max_memory_allocated() - before


def fit_transfer(card, resnet_runs):
    """The two stages of the recipe through ``SparkModel(json,
    mode="synchronous")`` at 1 worker, the fine-tuning stage from the frozen
    stage's fitted weights. Each: finite losses (falling in the frozen
    stage; at SGD 1e-5 two epochs of the fine-tuning stage move its loss
    by less than its batches' spread), exactly E S K1-fwd and K1-bwd
    launches and no other kernel; ms a step, the fit's peak memory, the
    launches a step; a profiled epoch over 64 rows (device ms a step, the
    host's calls of the convolution backward). The frozen stage leaves
    every base array bit for bit (weights and moving statistics) and moves
    the head, and its profiled epoch calls no convolution backward: no
    gradient flows through the base. The fine-tuning stage moves the base's
    kernels, gammas and betas, and moves its moving statistics: Keras 3.13
    runs a nested model's layers in the step's training mode, over the
    ``training=False`` saved with its call, as the reference's
    ``stateless_call`` and Keras's ``fit`` do. Beside fit_resnet's
    one-worker float32 run and a profiled epoch of its config."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = TRANSFER_FIT
    x, y = cifar_like(c["samples"])
    E, B, rows = c["epochs"], c["batch"], c["profiled_rows"]
    S, _ = _mlp_steps(c["samples"], 1, B, 0.0)
    rdd = to_simple_rdd(SparkContext("local[1]"), x, y, num_slices=1)
    part = to_simple_rdd(SparkContext("local[1]"), x[:rows], y[:rows], num_slices=1)
    conv_bwd = "aten::convolution_backward"
    stages, counts_by, weights = {}, {}, None
    for stage, path in (("frozen", TRANSFER_JSON), ("finetune", FINETUNE_JSON)):
        warm = _json_model(path, mode="synchronous", num_workers=1)
        warm.fit(to_simple_rdd(SparkContext("local[1]"), x[:2 * B], y[:2 * B], num_slices=1),
                 epochs=1, batch_size=B, validation_split=0.0)
        del warm
        sm = _json_model(path, mode="synchronous", frequency="epoch",
                         parameter_server_mode="jax", num_workers=1)
        if weights is not None:
            sm.master_network.set_weights(weights)
        specs = sm.master_network._specs
        w0 = sm.master_network.get_weights()
        (wall, counts, hist), peak = _fit_peak(lambda: _compiled_fit(
            f"fit_transfer {stage}", sm, rdd, E, B, 0.0, S, 0, falls=stage == "frozen"))
        w1 = sm.master_network.get_weights()
        same = [np.array_equal(a, b) for a, b in zip(w0, w1)]
        head = [i for i, s in enumerate(specs) if s.name.startswith("predictions/")]
        require(len(specs) == 320 and len(head) == 2,
                f"fit_transfer {stage}: {len(specs)} arrays, head {head}")
        require(not any(same[i] for i in head), f"fit_transfer {stage}: the head kept")
        base = [i for i in range(len(specs)) if i not in head]
        stats = [i for i in base if not specs[i].trainable and "moving_" in specs[i].name]
        if stage == "frozen":
            moved = [specs[i].name for i in base if not same[i]]
            require(not moved, f"fit_transfer frozen: base arrays moved: {moved[:4]} "
                               f"({len(moved)})")
            require(sum(s.trainable for s in specs) == 2,
                    f"fit_transfer frozen: {sum(s.trainable for s in specs)} trainable")
        else:
            learn = [i for i in base if specs[i].trainable and
                     specs[i].name.endswith(("/kernel", "/gamma", "/beta"))]
            kept = [specs[i].name for i in learn + stats if same[i]]
            require(not kept and len(learn) == 53 + 2 * 53,
                    f"fit_transfer finetune: {len(learn)} kernels, gammas and betas; kept "
                    f"{kept[:4]} ({len(kept)})")
        weights = w1
        prof = profiled(lambda: sm.fit(part, epochs=1, batch_size=B, validation_split=0.0),
                        1, top_n=8, ops=(conv_bwd,))
        steps = rows // B
        n_bwd = prof["op_counts"][conv_bwd]
        require((n_bwd == 0) == (stage == "frozen"),
                f"fit_transfer {stage}: {n_bwd} convolution backward calls in {steps} steps")
        stages[stage] = {
            "config": path, "trainable_arrays": sum(s.trainable for s in specs),
            "steps_per_epoch": S, "fit_s": wall, "ms_per_step": wall * 1e3 / (E * S),
            "samples_per_s": c["samples"] * E / wall, "history": hist,
            "launches": {k: v for k, v in counts.items() if v},
            "launches_per_step": {k: v / (E * S) for k, v in counts.items() if v},
            "fit_peak_bytes": peak,
            "base_arrays_moved": sum(not same[i] for i in base),
            "moving_statistics_moved": sum(not same[i] for i in stats),
            "profiled_fit_1_epoch": {**prof, "steps": steps,
                                     "device_ms_per_train_step":
                                         prof["device_ms_per_step"] / steps,
                                     "wall_ms_per_train_step": prof["wall_ms_per_step"] / steps,
                                     "conv_backward_calls_per_step": n_bwd / steps}}
        counts_by[f"fit_transfer_{stage}"] = counts
        del sm
        torch.cuda.empty_cache()
    # the float32 ResNet-50 of fit_resnet, profiled the same way in this process
    psm = _json_model(RESNET_JSON, mode="synchronous", frequency="epoch",
                      parameter_server_mode="jax", num_workers=1)
    psm.fit(part, epochs=1, batch_size=B, validation_split=0.0)
    prof = profiled(lambda: psm.fit(part, epochs=1, batch_size=B, validation_split=0.0), 1,
                    top_n=8, ops=(conv_bwd,))
    del psm
    torch.cuda.empty_cache()
    f32 = next(r for r in resnet_runs if r["workers"] == 1 and not r["remat"])
    emit({"phase": "fit_transfer", **c, "stages": stages,
          "fit_resnet_1_worker_float32": {
              "ms_per_step": f32["ms_per_step"], "fit_peak_bytes": f32["fit_peak_bytes"],
              "launches_per_step": {k: v / (E * f32["steps_per_epoch"])
                                    for k, v in f32["launches"].items()},
              "device_ms_per_train_step": prof["device_ms_per_step"] / (rows // B),
              "conv_backward_calls_per_step": prof["op_counts"][conv_bwd] / (rows // B)},
          "card": card})
    return counts_by


def fit_transfer_cross_check(card):
    """The card against ``device="cpu"`` from the same weights and order.
    The frozen stage: 2 epochs of 64 images at 1 worker (batch 16) from the
    config's weights with every 1-D array drawn wide (:func:`_resnet_weights`,
    so that the frozen BatchNormalization normalises): histories within
    rtol 1e-4 plus 1e-6, the head's arrays within 1e-4 of their scale, the
    base bit for bit on both. The fine-tuning stage under
    ``fit_resnet_cross_check``'s rules, one step of 16 images: the loss
    within rtol 1e-4, the moved statistics and the head within 1e-4 of
    their scale, each array's distance to the float64 step at most 4 times
    the CPU float32 step's largest; its statistics moved on both."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.models import KerasModelAdapter
    from elephas_tpu_torch.parallel import CompiledTrainer
    from elephas_tpu_torch.utils import to_simple_rdd

    c = TRANSFER_FIT
    x, y = cifar_like(c["cross_rows"], seed=4)
    w = _resnet_weights(SEED + 53)
    got = {}
    for dev in ("cuda", "cpu"):
        sm = _json_model(TRANSFER_JSON, device=dev, mode="synchronous", frequency="epoch",
                         parameter_server_mode="jax", num_workers=1)
        sm.master_network.set_weights(w)
        sm.fit(to_simple_rdd(SparkContext("local[1]"), x, y, num_slices=1),
               epochs=c["epochs"], batch_size=c["batch"], validation_split=0.0)
        got[dev] = (sm.training_histories[-1], sm.master_network.get_weights())
        specs = sm.master_network._specs
    head = [i for i, s in enumerate(specs) if s.name.startswith("predictions/")]
    for dev in got:
        moved = [specs[i].name for i, (a, b) in enumerate(zip(got[dev][1], w))
                 if i not in head and not np.array_equal(a, b)]
        require(not moved, f"fit_transfer_cross_check frozen ({dev}): base moved {moved[:4]}")
    hist_err = _histories_within("fit_transfer_cross_check frozen", got["cuda"][0],
                                 got["cpu"][0])
    head_errs = _weights_within("fit_transfer_cross_check frozen head",
                                [got["cuda"][1][i] for i in head],
                                [got["cpu"][1][i] for i in head])
    with open(FINETUNE_JSON) as f:
        text = f.read()
    w = _resnet_weights(SEED + 54)
    xs, ys = cifar_like(16, seed=5)
    out = {}
    for dev in ("cuda", "cpu"):
        trainer = CompiledTrainer(KerasModelAdapter(text, device=dev), mode="synchronous")
        trainer.adapter.set_weights(w)
        res = trainer.fit([(xs, ys)], epochs=1, batch_size=16)
        out[dev] = (res.history["loss"][0], res.weights)
    specs = trainer.adapter._specs
    oracle = _resnet_step64(text, w, xs, ys)
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    require(loss_rel <= 1e-4, f"fit_transfer_cross_check finetune: loss {out['cuda'][0]} "
                              f"(card) vs {out['cpu'][0]} (CPU)")
    stats = [i for i, s in enumerate(specs) if not s.trainable]
    for dev in out:
        kept = [specs[i].name for i in stats if np.array_equal(out[dev][1][i], w[i])]
        require(not kept, f"fit_transfer_cross_check finetune ({dev}): statistics kept "
                          f"{kept[:4]}")
    smooth = stats + [i for i, s in enumerate(specs) if s.name.startswith("predictions/")]
    smooth_errs = _weights_within("fit_transfer_cross_check finetune: statistics and head",
                                  [out["cuda"][1][i] for i in smooth],
                                  [out["cpu"][1][i] for i in smooth])

    def to_oracle(ws):
        return [float(np.abs(a - o).max()) / float(np.abs(o).max() or 1.0)
                for a, o in zip(ws, oracle)]

    card_o, cpu_o = to_oracle(out["cuda"][1]), to_oracle(out["cpu"][1])
    i = int(np.argmax(card_o))
    require(card_o[i] <= 4 * max(cpu_o),
            f"fit_transfer_cross_check finetune: the card's step lies {card_o[i]} of scale "
            f"from the float64 step ({specs[i].name}), the CPU's at most {max(cpu_o)}")
    emit({"phase": "fit_transfer_cross_check",
          "frozen": {"history_rel_err": hist_err, "head_err_rel_to_scale": max(head_errs),
                     "history_gpu": got["cuda"][0], "history_cpu": got["cpu"][0],
                     "base_bit_for_bit": True},
          "finetune": {"loss_card": out["cuda"][0], "loss_cpu": out["cpu"][0],
                       "loss_rel_err": loss_rel, "stats_and_head_err": max(smooth_errs),
                       "card_to_float64_max": card_o[i], "cpu_to_float64_max": max(cpu_o)},
          "card": card})


def _graph_data(name: str, n: int, seed: int):
    """Seeded rows for each small model of ``graph_options.json``."""
    rng = np.random.default_rng(seed)
    if name in ("lstm_states", "stateful_lstm"):
        x = rng.normal(size=(n, 12, 8)).astype(np.float32)
        proj = np.random.default_rng(SEED + 71).normal(size=(8, 10))
        return x, np.eye(10, dtype=np.float32)[(x.mean(1) @ proj).argmax(1)]
    if name == "masked_classifier":
        x, y1 = padded_ids(n, 500, 20, seed)
        return x.astype(np.float32), np.concatenate([1 - y1, y1], axis=1)
    if name == "ctc":
        x = rng.normal(size=(n, 16, 8)).astype(np.float32)
        proj = np.random.default_rng(SEED + 72).normal(size=(8, 5))
        labels = (x[:, ::4] @ proj).argmax(-1) + 1
        labels[np.arange(4)[None, :] >= rng.integers(1, 5, size=n)[:, None]] = 0
        return x, labels.astype(np.float32)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    proj = np.random.default_rng(SEED + 73).normal(size=(32, 4))
    return x, np.eye(4, dtype=np.float32)[(x @ proj).argmax(1)]


def _results_within(what, got, want, rtol=1e-4, atol=1e-6):
    """Evaluate results (floats or arrays) within ``rtol`` plus ``atol``;
    the largest relative difference."""
    errs = []
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        require(a.shape == b.shape and np.all(np.abs(a - b) <= rtol * np.abs(b) + atol),
                f"{what}: {got} vs {want}")
        errs.append(float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6))))
    return max(errs)


def fit_graph_options(card):
    """The small models of ``configs/graph_options.json``, the card against
    ``device="cpu"`` from the same weights and order. Compiled path (2
    workers, synchronous, 1024 samples, batch 32, 2 epochs): the
    encoder-decoder LSTMs (``return_state``, ``initial_state``), the masked
    bag-of-embeddings classifier, the ``stateful`` LSTM and the ``ctc``
    tagger (``CTC()``: its forward recursion is deterministic, so its
    gradients take the same 1e-4). Host path (``comm="host"``, one worker,
    512 samples, seeded ``np.random``): the ``stateful`` LSTM, and the MLP
    compiled with ``AUC(from_logits=True)``, ``Precision()`` and
    ``F1Score()`` (a vector result), with validation 0.25, its history's
    metrics and their ``val_`` copies; then ``SparkModel.evaluate`` (the
    fall-back, batches of 32, 200 rows). Histories and evaluations within
    rtol 1e-4 plus 1e-6, the arrays within 1e-4 of their scale; K1 exactly
    E S each way on each logits head's compiled fit (E S and E Sv
    forward on the host fits), no kernel for ``ctc``."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = GRAPH_FIT
    with open(GRAPH_OPTIONS_JSON) as f:
        models = json.load(f)
    W, B, E = c["workers"], c["batch"], c["epochs"]
    report, counts_by = {}, {}
    for i, name in enumerate(("lstm_states", "masked_classifier", "stateful_lstm", "ctc")):
        x, y = _graph_data(name, c["samples"], SEED + 74 + i)
        S, _ = _mlp_steps(c["samples"], W, B, 0.0)
        got, w0 = {}, None
        for dev in ("cuda", "cpu"):
            sm = SparkModel(models[name], device=dev, mode="synchronous", num_workers=W)
            if w0 is None:
                w0 = sm.master_network.get_weights()
            sm.master_network.set_weights(w0)
            rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x, y, num_slices=W)
            if dev == "cuda":
                wall, counts, _ = _compiled_fit(f"fit_graph_options {name}", sm, rdd, E, B,
                                                0.0, S, 0, k1=name != "ctc")
                counts_by[f"fit_graph_options_{name}"] = counts
                report[name] = {"fit_s": wall, "ms_per_step": wall * 1e3 / (E * S)}
            else:
                sm.fit(rdd, epochs=E, batch_size=B, validation_split=0.0)
            got[dev] = (sm.training_histories[-1], sm.master_network.get_weights())
        report[name].update({
            "history_gpu": got["cuda"][0],
            "history_rel_err": _histories_within(f"fit_graph_options {name}", got["cuda"][0],
                                                 got["cpu"][0]),
            "weight_err_rel_to_scale": max(_weights_within(f"fit_graph_options {name}",
                                                           got["cuda"][1], got["cpu"][1]))})
    n = c["host_samples"]
    for name, split in (("stateful_lstm", 0.0), ("metrics_mlp", 0.25)):
        x, y = _graph_data(name, n, SEED + 80)
        xe, ye = _graph_data(name, c["eval_rows"], SEED + 81)
        n_train = int(np.floor(n * (1.0 - split)))
        S, Sv = -(-n_train // B), -(-(n - n_train) // B)
        got, w0 = {}, None
        # the host path's workers compile with master_metrics (none by
        # default, as the reference's): the config's own metrics, passed
        metrics = json.loads(models[name])["compile_config"]["metrics"] \
            if name == "metrics_mlp" else None
        for dev in ("cuda", "cpu"):
            sm = SparkModel(models[name], device=dev, mode="synchronous", comm="host",
                            num_workers=1, port=0, master_metrics=metrics)
            if w0 is None:
                w0 = sm.master_network.get_weights()
            sm.master_network.set_weights(w0)
            np.random.seed(SEED + 82)
            if dev == "cuda":
                torch.cuda.synchronize()
                _zero_counters()
            t0 = time.perf_counter()
            sm.fit(to_simple_rdd(SparkContext("local[1]"), x, y, num_slices=1), epochs=E,
                   batch_size=B, validation_split=split)
            wall = time.perf_counter() - t0
            counts = _read_counters() if dev == "cuda" else None
            ev = sm.evaluate(xe, ye) if name == "metrics_mlp" else None
            got[dev] = (sm.training_histories[-1], sm.master_network.get_weights(), counts,
                        ev, wall)
        hist_c, w_c, counts, ev_c, wall = got["cuda"]
        hist_p, w_p, _, ev_p, _ = got["cpu"]
        what = f"fit_graph_options host {name}"
        want = {"fused_xent_fwd": E * (S + (Sv if split else 0)), "fused_xent_bwd": E * S}
        for k, v in want.items():
            require(counts[k] == v, f"{what}: {k} launched {counts[k]} times, want {v}")
        others = {k: v for k, v in counts.items() if not k.startswith("fused_xent") and v}
        require(not others, f"{what}: other kernels launched: {others}")
        counts_by[f"fit_graph_options_host_{name}"] = counts
        require(set(hist_c) == set(hist_p), f"{what}: history keys {sorted(hist_c)}")
        keys = ({"loss"} if name == "stateful_lstm" else
                {p + k for p in ("", "val_") for k in ("loss", "auc", "precision", "f1_score")})
        require(set(hist_c) == keys, f"{what}: history keys {sorted(hist_c)}, want "
                                     f"{sorted(keys)}")
        errs = [_results_within(f"{what} {k}", hist_c[k], hist_p[k]) for k in hist_p]
        w_errs = _weights_within(what, w_c, w_p)
        entry = {"fit_s": wall, "ms_per_step": wall * 1e3 / (E * S),
                 "history_gpu": {k: [np.asarray(v).tolist() for v in vs]
                                 for k, vs in hist_c.items()},
                 "history_rel_err": max(errs), "weight_err_rel_to_scale": max(w_errs),
                 "launches": {k: v for k, v in counts.items() if v}}
        if ev_c is not None:
            require(isinstance(ev_c, list) and len(ev_c) == 4 and np.shape(ev_c[3]) == (4,),
                    f"{what}: evaluate gave {ev_c}")
            entry["evaluate"] = {"names": ["loss", "auc", "precision", "f1_score"],
                                 "card": [np.asarray(v).tolist() for v in ev_c],
                                 "rel_err": _results_within(f"{what} evaluate", ev_c, ev_p)}
        report[f"host_{name}"] = entry
    emit({"phase": "fit_graph_options", **c, "fits": report, "card": card})
    return counts_by


# -- phases 33 to 36: the API skins around SparkModel ------------------------------

# examples/ml_mlp.py (8192 MNIST-shaped rows, 1024 held out, batch 64, 3 epochs,
# validation 0.1, synchronous, "jax", 8 workers) over the committed logits-head
# JSON; examples/ml_pipeline_imdb_lstm.py's pipeline (batch 64, 2 epochs, no
# validation) on LSTM_FIT's 8192 sequences; examples/hyperparam_optimization.py's
# search (4 workers, 3 evaluations each, batch 128, 2 epochs) on 2048 rows (its
# rows cut for the script's time limit). Widths and schedules are the examples'.
ML_MLP = dict(samples=8192, held_out=1024, batch=64, workers=8, epochs=3,
              validation_split=0.1)
ML_LSTM = dict(held_out=1024, batch=64, workers=8, epochs=2)
HYPER = dict(samples=2048, held_out=1024, batch=128, epochs=2, validation_split=0.1,
             workers=4, max_evals=3, best=2)


def _vector_frame(spark, x, labels):
    """A DataFrame of ``Row(features=Vectors.dense(x_i as float64),
    label=float(label_i))``, as the examples build theirs."""
    from elephas_tpu_torch.data import Row
    from elephas_tpu_torch.mllib import Vectors

    return spark.createDataFrame([Row(features=Vectors.dense(a.astype("float64")),
                                      label=float(b)) for a, b in zip(x, labels)])


def _compiled_estimator(path, **params):
    """``ElephasEstimator`` over a committed JSON with its compile config's
    optimizer and loss, synchronous on the compiled path."""
    from elephas_tpu_torch import ElephasEstimator

    with open(path) as f:
        text = f.read()
    cc = json.loads(text)["compile_config"]
    est = ElephasEstimator()
    est.set_keras_model_config(text)
    est.set_optimizer_config(cc["optimizer"])
    est.set_loss(cc["loss"])
    est.set_metrics(["accuracy"])
    est.setParams(mode="synchronous", parameter_server_mode="jax", **params)
    return est, text


def _timed_fit(fit):
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    out = fit()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, _read_counters()


def ml_mlp(card):
    """``examples/ml_mlp.py`` through the port without Keras: a DataFrame of
    8192 MNIST-shaped rows, ``ElephasEstimator`` over the committed
    logits-head JSON, ``fit``, then ``transform`` of a 1024-row test frame.
    Exactly E (S + Sv) K1-fwd and E S K1-bwd launches and no other kernel
    in the fit; the trained weights' loss on the training rows below the
    initial weights' (the estimator keeps no history); the ``prediction``
    column equal to the argmax of the trained network's predictions,
    exactly. ms a step of the first fit and of a second (set-up included:
    each fit converts the frame and stages the blocks anew)."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkSession
    from elephas_tpu_torch.models import KerasModelAdapter

    c = ML_MLP
    W, E, B, split = c["workers"], c["epochs"], c["batch"], c["validation_split"]
    (x, y), (xt, yt) = mnist_like(c["samples"], c["held_out"])
    spark = SparkSession.builder.master(f"local[{W}]").appName("ml_mlp").getOrCreate()
    t0 = time.perf_counter()
    df, test_df = _vector_frame(spark, x, y.argmax(1)), _vector_frame(spark, xt, yt.argmax(1))
    frame_s = time.perf_counter() - t0
    est, text = _compiled_estimator(MNIST_JSON, categorical=True, nb_classes=10,
                                    num_workers=W, epochs=E, batch_size=B,
                                    validation_split=split)
    S, Sv = _mlp_steps(c["samples"], W, B, split)
    tr, wall, counts = _timed_fit(lambda: est.fit(df))
    want = {"fused_xent_fwd": E * (S + Sv), "fused_xent_bwd": E * S}
    for name, n in want.items():
        require(counts[name] == n, f"ml_mlp: {name} launched {counts[name]} times, want "
                                   f"{n} (E {E}, S {S}, Sv {Sv})")
    others = {k: v for k, v in counts.items() if k not in want and v}
    require(not others, f"ml_mlp: other kernels launched: {others}")
    _, wall2, _ = _timed_fit(lambda: est.fit(df))
    before = SparkModel(text, mode="synchronous").evaluate(x, y)
    after = SparkModel({"model": text, "weights": tr.weights}, mode="synchronous")
    after_eval = after.evaluate(x, y)
    require(np.isfinite(after_eval[0]) and after_eval[0] < before[0],
            f"ml_mlp: training loss {before[0]} -> {after_eval[0]} did not fall")
    out = tr.transform(test_df)
    rows = out.collect()
    pred = np.array([r.prediction for r in rows])
    net = KerasModelAdapter(text, weights=tr.weights, device="cuda")
    want_pred = net.predict(xt).argmax(1).astype(np.float64)
    require(out.columns == ["features", "label", "prediction"],
            f"ml_mlp: columns {out.columns}")
    require(np.array_equal(pred, want_pred), "ml_mlp: prediction column differs from the "
            f"argmax of the network's predictions at {int((pred != want_pred).sum())} rows")
    acc = float((pred == yt.argmax(1)).mean())
    require(acc > 0.5, f"ml_mlp: held-out accuracy {acc} (chance is 0.1)")
    emit({"phase": "ml_mlp", "config": MNIST_JSON, **c, "mode": "synchronous",
          "steps_per_epoch": S, "val_steps_per_epoch": Sv, "frames_s": frame_s,
          "fit_s": wall, "fit2_s": wall2, "ms_per_step": wall * 1e3 / (E * S),
          "ms_per_step_fit2": wall2 * 1e3 / (E * S),
          "train_eval_before": before, "train_eval_after": after_eval,
          "held_out_accuracy": acc, "launches": counts, "launches_want": want,
          "card": card})
    return counts, est, tr, xt


def ml_pipeline_lstm(card):
    """``examples/ml_pipeline_imdb_lstm.py``'s pipeline at full width:
    ``Pipeline(stages=[ElephasEstimator])`` over the committed LSTM JSON on
    LSTM_FIT's 8192 id sequences, not categorical, batch 64, 2 epochs, no
    validation, synchronous, 8 workers. The trained weights equal, bit for
    bit, those of ``SparkModel.fit`` of the same JSON on the same rows in
    the same partitions on this card; no kernel of the port launched (a
    sigmoid head); the training loss fell; the test frame's accuracy. ms a
    step of the pipeline's fit (which also transforms the training frame,
    as ``Pipeline.fit`` does), of the estimator's fit alone (a second fit)
    and of the direct fit."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext, SparkSession
    from elephas_tpu_torch.ml import Pipeline
    from elephas_tpu_torch.utils import to_simple_rdd

    c = ML_LSTM
    n = LSTM_FIT["samples"]
    W, E, B = c["workers"], c["epochs"], c["batch"]
    x, y = imdb_like(n + c["held_out"], LSTM_FIT["vocab"], LSTM_FIT["maxlen"])
    (x, y), (xt, yt) = (x[:n], y[:n]), (x[n:], y[n:])
    spark = SparkSession.builder.master(f"local[{W}]").appName("imdb_lstm").getOrCreate()
    df, test_df = _vector_frame(spark, x, y[:, 0]), _vector_frame(spark, xt, yt[:, 0])
    est, text = _compiled_estimator(LSTM_JSON, categorical=False, num_workers=W, epochs=E,
                                    batch_size=B, validation_split=0.0)
    S, _ = _mlp_steps(n, W, B, 0.0)
    fitted, wall, counts = _timed_fit(lambda: Pipeline(stages=[est]).fit(df))
    require(not any(counts.values()),
            f"ml_pipeline_lstm: kernels launched: { {k: v for k, v in counts.items() if v} }")
    tr = fitted.stages[0]
    # the same JSON, rows and partitions, straight through SparkModel
    sm = SparkModel(text, mode="synchronous", parameter_server_mode="jax", num_workers=W)
    rdd = to_simple_rdd(SparkContext(f"local[{W}]"), x.astype(np.float32),
                        y[:, 0].astype(np.float32), num_slices=W)
    _, direct_wall, _ = _timed_fit(lambda: sm.fit(rdd, epochs=E, batch_size=B,
                                                  validation_split=0.0))
    direct = sm.master_network.get_weights()
    same = len(direct) == len(tr.weights) and all(
        a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(tr.weights, direct))
    require(same, "ml_pipeline_lstm: the pipeline's weights differ from SparkModel.fit's: "
            + str([float(np.abs(a - b).max()) for a, b in zip(tr.weights, direct)]))
    hist = sm.training_histories[-1]
    require(hist["loss"][-1] < hist["loss"][0],
            f"ml_pipeline_lstm: loss did not fall: {hist['loss']}")
    _, est_wall, _ = _timed_fit(lambda: est.fit(df))
    t0 = time.perf_counter()
    out = fitted.transform(test_df).collect()
    transform_s = time.perf_counter() - t0
    pred = np.array([r.prediction for r in out])
    require(pred.shape == (c["held_out"],) and bool(np.isfinite(pred).all()),
            f"ml_pipeline_lstm: predictions {pred.shape}")
    acc = float(((pred > 0.5) == (yt[:, 0] > 0.5)).mean())
    emit({"phase": "ml_pipeline_lstm", "config": LSTM_JSON, **c, "samples": n,
          "steps_per_epoch": S, "pipeline_fit_s": wall,
          "pipeline_ms_per_step": wall * 1e3 / (E * S), "estimator_fit_s": est_wall,
          "ms_per_step": est_wall * 1e3 / (E * S), "direct_fit_s": direct_wall,
          "direct_ms_per_step": direct_wall * 1e3 / (E * S),
          "test_transform_s": transform_s,
          "bitwise_equal_to_direct_fit": same, "history_direct": hist,
          "test_accuracy": acc, "launches": {k: v for k, v in counts.items() if v},
          "card": card})


def ml_persist(card, est, tr, xt):
    """``save`` of ``ml_mlp``'s estimator and transformer, then
    ``load_ml_estimator`` / ``load_ml_transformer`` on the card: the same
    params, the reloaded transformer's predictions equal the original's
    exactly; both files load on ``device="cpu"`` too (its predictions
    within 1e-5 of the card's)."""
    import os
    import tempfile

    from elephas_tpu_torch import load_ml_estimator, load_ml_transformer

    with tempfile.TemporaryDirectory() as d:
        pe, pt = os.path.join(d, "estimator.npz"), os.path.join(d, "transformer.npz")
        est.save(pe)
        tr.save(pt)
        sizes = {"estimator_bytes": os.path.getsize(pe), "transformer_bytes": os.path.getsize(pt)}
        est2, tr2 = load_ml_estimator(pe), load_ml_transformer(pt)
        est_cpu, tr_cpu = load_ml_estimator(pe, device="cpu"), load_ml_transformer(pt, device="cpu")
    require(est2.param_values() == est.param_values() == est_cpu.param_values(),
            "ml_persist: the estimator's params changed in the round trip")
    want = tr.get_model().predict(xt)
    got = tr2.get_model().predict(xt)
    require(tr2.get_model().device.type == "cuda" and np.array_equal(got, want),
            "ml_persist: the reloaded transformer predicts otherwise")
    cpu_err = float(np.abs(tr_cpu.get_model().predict(xt) - want).max())
    require(cpu_err <= 1e-5 * max(float(np.abs(want).max()), 1.0),
            f"ml_persist: the CPU load predicts {cpu_err} away")
    emit({"phase": "ml_persist", **sizes, "rows": len(xt), "same_bits_on_card": True,
          "cpu_load_max_abs_err": cpu_err, "card": card})


_HYPER_TRIALS = []      # every trial's (network, loss, accuracy), appended by hyper_model


def hyper_data():
    (x, y), (xt, yt) = mnist_like(HYPER["samples"], HYPER["held_out"])
    return x, y, xt, yt


def hyper_model(x_train, y_train, x_test, y_test):
    """``examples/hyperparam_optimization.py``'s model function on the
    port: the committed MNIST MLP JSON with the first Dense's units and the
    first Dropout's rate searched, fitted by ``SparkModel`` (synchronous, 1
    worker) on the card. The loss is the held-out mean cross-entropy of the
    logits, in float64 on the host: the example's minus accuracy is 1.0 on
    every trial on these separable blobs, which leaves the search nothing to
    rank."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    with open(MNIST_JSON) as f:
        cfg = json.load(f)
    layers = cfg["config"]["layers"]
    dense = [layer for layer in layers if layer["class_name"] == "Dense"]
    units = {{choice([64, 128, 256])}}
    dense[0]["config"]["units"] = units
    dense[1]["build_config"]["input_shape"] = [None, units]
    dropout = next(layer for layer in layers if layer["class_name"] == "Dropout")
    dropout["config"]["rate"] = {{uniform(0.0, 0.5)}}
    c = HYPER
    sm = SparkModel(json.dumps(cfg), mode="synchronous", num_workers=1)
    sm.fit(to_simple_rdd(SparkContext("local[1]"), x_train, y_train, num_slices=1),
           epochs=c["epochs"], batch_size=c["batch"], validation_split=c["validation_split"])
    z = sm.predict(x_test).astype(np.float64)
    z -= z.max(1, keepdims=True)
    loss = float((np.log(np.exp(z).sum(1)) - (z * y_test).sum(1)).mean())
    acc = float((z.argmax(1) == y_test.argmax(1)).mean())
    _HYPER_TRIALS.append((sm.master_network, loss, acc))
    return {"loss": loss, "status": STATUS_OK, "model": sm.master_network}


def hyperparam(card):
    """``HyperParamModel(sc, num_workers=4).minimize(hyper_model, hyper_data,
    max_evals=3)`` on the card, then ``best_models(2, ...)``: 12 trials a
    search, each within its spaces and recording its card; K1 launched
    exactly the sum over the trials of their fits' E (S + Sv) and E S,
    counted from the 4 worker threads; the trials' losses (held-out
    cross-entropy) not all equal; the rebuilt best model is the trial of
    least loss and predicts exactly as its network; the ensemble's members
    are the two least-loss trials of ``best_models``' own search and its
    prediction is [n, 10]. Each trial's device, loss and accuracy, and the
    wall times."""
    from elephas_tpu_torch import HyperParamModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.hyperparam import STATUS_OK, VotingModel

    class Recording(HyperParamModel):
        """Keeps the last search's trials, which ``minimize`` reduces to
        the best one."""

        def compute_trials(self, *args, **kwargs):
            self.trials = super().compute_trials(*args, **kwargs)
            return self.trials

    c = HYPER
    W, n_evals = c["workers"], c["max_evals"]
    hp = Recording(SparkContext(f"local[{W}]"), num_workers=W)
    _HYPER_TRIALS.clear()
    best, wall, counts = _timed_fit(lambda: hp.minimize(hyper_model, hyper_data,
                                                        max_evals=n_evals))
    trials = hp.trials
    S, Sv = _mlp_steps(c["samples"], 1, c["batch"], c["validation_split"])
    E, n_trials = c["epochs"], W * n_evals
    require(len(trials) == n_trials == len(_HYPER_TRIALS),
            f"hyperparam: {len(trials)} trials, {len(_HYPER_TRIALS)} fits, want {n_trials}")
    for t in trials:
        units, rate = t["params"]
        require(units in (64, 128, 256) and 0.0 <= rate <= 0.5 and t["status"] == STATUS_OK,
                f"hyperparam: a trial outside its spaces: {t['params']}")
    want = {"fused_xent_fwd": n_trials * E * (S + Sv), "fused_xent_bwd": n_trials * E * S}
    for name, n in want.items():
        require(counts[name] == n, f"hyperparam: {name} launched {counts[name]} times, "
                                   f"want {n} ({n_trials} trials, E {E}, S {S}, Sv {Sv})")
    others = {k: v for k, v in counts.items() if k not in want and v}
    require(not others, f"hyperparam: other kernels launched: {others}")
    losses = sorted(t["loss"] for t in trials)
    require(losses[0] < losses[-1], f"hyperparam: every trial's loss is {losses[0]}")
    accuracy = {loss: acc for _, loss, acc in _HYPER_TRIALS}

    def sources(model):
        """The recorded trials whose trained weights are ``model``'s."""
        w = model.get_weights()
        return [(net, loss) for net, loss, _ in _HYPER_TRIALS
                if len(net.get_weights()) == len(w)
                and all(np.array_equal(a, b) for a, b in zip(net.get_weights(), w))]

    xt = hyper_data()[2]
    source = sources(best)
    require(len(source) == 1 and best.device.type == "cuda",
            f"hyperparam: the best model matches {len(source)} trials")
    require(source[0][1] == losses[0],
            f"hyperparam: the best model's trial has loss {source[0][1]}, the least is "
            f"{losses[0]}")
    require(np.array_equal(best.predict(xt), source[0][0].predict(xt)),
            "hyperparam: the rebuilt best model predicts otherwise than its trial")
    _HYPER_TRIALS.clear()
    t0 = time.perf_counter()
    ensemble = hp.best_models(c["best"], hyper_model, hyper_data, max_evals=n_evals)
    torch.cuda.synchronize()
    best_models_s = time.perf_counter() - t0
    votes = ensemble.predict(xt)
    require(isinstance(ensemble, VotingModel) and len(ensemble.models) == c["best"]
            and votes.shape == (len(xt), 10) and bool(np.isfinite(votes).all()),
            f"hyperparam: the ensemble's prediction is {votes.shape}")
    member_losses = sorted(loss for m in ensemble.models for _, loss in sources(m))
    least = sorted(t["loss"] for t in hp.trials)[:c["best"]]
    require(member_losses == least,
            f"hyperparam: the ensemble's trials have losses {member_losses}, the least are "
            f"{least}")
    emit({"phase": "hyperparam", **c, "steps_per_epoch": S, "val_steps_per_epoch": Sv,
          "minimize_s": wall, "best_models_s": best_models_s,
          "trials": [{"device": t["device"], "params": t["params"], "loss": t["loss"],
                      "accuracy": accuracy[t["loss"]]} for t in trials],
          "best_loss": losses[0], "ensemble_accuracy": float(
              (votes.argmax(1) == hyper_data()[3].argmax(1)).mean()),
          "launches": counts, "launches_want": want, "card": card})
    return counts


# -- resilience, streaming and the serving fleet (item 10's first part) -------------

FLEET_TRACE = dict(seed=3, base_rps=4.0, duration_s=12.0, n_tenants=4, sampled_frac=0.5,
                   burst_amp=2.0, vocab=GPT2_SMALL["vocab"], prompt_len_median=64.0,
                   prompt_len_max=256, max_new_median=32.0, max_new_max=64)
FLEET_CHAOS = [{"t": 2.0, "op": "kill", "pid": 0}, {"t": 2.5, "op": "join"}]
FLEET_SLOTS = 8
FLEET_STEP_DT = 0.05
STREAM_LAYERS = 4              # the stream model's depth (GPT-2-small's width)


class _WallClock:
    """The card's own time for a trace replay: seconds since construction on
    ``time.monotonic``; ``advance`` waits for nothing (the replay runs as
    fast as the fleet steps, arrivals released as the wall passes them)."""

    def __init__(self):
        self.t0 = time.monotonic()

    def __call__(self):
        return time.monotonic() - self.t0

    def advance(self, dt):
        return self()


def _fleet_trace():
    from elephas_tpu_torch.fleet import TrafficModel

    return TrafficModel(**FLEET_TRACE).generate()


def _fleet_run(model, params, trace, *, paged, chaos, clock, check=False):
    """One replay of ``trace`` through two partitions (``n_slots`` 8 each,
    sharing ``params``; each its own cache) on ``clock``, with ``chaos``'s
    kill and join; ``check`` runs ``kv.check()`` after every fleet step.
    Returns the router, its snapshot and every engine the factory built
    (the killed one included, for the launch counts)."""
    from elephas_tpu_torch.fleet import FleetPolicy, FleetRouter, run_trace
    from elephas_tpu_torch.serving import ServingEngine

    made = []

    def factory(pid):
        eng = ServingEngine(model, params, n_slots=FLEET_SLOTS, paged=paged, page_size=16,
                            clock=clock, perf_clock=clock, device="cuda")
        made.append(eng)
        return eng

    router = FleetRouter(factory, 2, policy=FleetPolicy(), clock=clock, lease_s=0.5)
    if not check:
        snap = run_trace(router, trace, clock=clock, step_dt=FLEET_STEP_DT, chaos=chaos)
        return router, snap, made
    pending = sorted(trace.requests, key=lambda r: (r.arrival_s, r.request_id))
    events = sorted(chaos or [], key=lambda e: e["t"])
    i = e = steps = 0
    while True:
        now = clock()
        while e < len(events) and events[e]["t"] <= now:
            ev = events[e]
            e += 1
            (router.kill_partition(ev["pid"]) if ev["op"] == "kill"
             else router.join_partition())
        while i < len(pending) and pending[i].arrival_s <= now:
            router.submit(pending[i])
            i += 1
        router.step()
        for pid in router.partition_ids():
            router._engines[pid].kv.check()
        if i >= len(pending) and e >= len(events) and router.active == 0:
            break
        steps += 1
        require(steps < 200000, "fleet replay did not drain")
        clock.advance(FLEET_STEP_DT)
    return router, router.snapshot(), made


def _fleet_checks(what, trace, router, snap, made, paged, migrated=True):
    """Every request terminal, migrations (unless ``migrated`` is false),
    and the exact launch counts of the run's engines (read just after it):
    L K4 (or K5-decode) a decode step, L K5-chunk an insert on the paged
    engine, 2L+1 K3-fwd a step and an insert, nothing else."""
    L = GPT2_SMALL["n_layers"]
    counts = _read_counters()
    f = snap["fleet"]
    require(f["done"] == len(trace) and f["queued"] == 0 and f["running"] == 0,
            f"{what}: not every request terminal: {f}")
    require(router.migrations > 0 or not migrated, f"{what}: the kill migrated nothing")
    steps = sum(e.snapshot()["engine"]["decode_steps"] for e in made)
    inserts = sum(e.snapshot()["engine"]["prefills"] for e in made)
    want = {"layer_norm_fwd": (2 * L + 1) * (steps + inserts)}
    if paged:
        want.update(paged_flash_decode_lse=L * steps, paged_flash_chunk=L * inserts)
    else:
        want.update(flash_decode_lse=L * steps)
    for name, n in want.items():
        require(counts[name] == n, f"{what}: {name} launched {counts[name]} times, want "
                                   f"{n} ({steps} decode steps, {inserts} inserts)")
    others = {k: v for k, v in counts.items() if k not in want and v}
    require(not others, f"{what}: other kernels launched: {others}")
    return counts, steps, inserts


def _fleet_summary(snap, trace):
    slo = snap["slo"]
    return {"requests": len(trace), "fleet": snap["fleet"],
            "deadline_with": slo["with_deadline"], "deadline_missed": slo["deadline_missed"],
            "deadline_miss_share": (slo["deadline_missed"] / slo["deadline_done"]
                                    if slo["deadline_done"] else None),
            "latency_sim_s": snap["latency"]}


def _fleet_wall(model, params, trace, paged):
    """The chaos replay again on the card's own time: fleet tok/s, TTFT and
    ITL p50 / p99 (seconds on ``time.monotonic``)."""
    clock = _WallClock()
    router, snap, _ = _fleet_run(model, params, trace, paged=paged, chaos=FLEET_CHAOS,
                                 clock=clock)
    torch.cuda.synchronize()
    wall = clock()
    res = router.results()
    n_tok = sum(len(s.tokens) for s in res.values())
    lat = snap["latency"]
    return {"wall_s": wall, "tokens": n_tok, "tok_per_s": n_tok / wall,
            "ttft_p50_s": lat["ttft_p50"], "ttft_p99_s": lat["ttft_p99"],
            "itl_p50_s": lat["itl_p50"], "itl_p99_s": lat["itl_p99"],
            "migrations": router.migrations, "done": snap["fleet"]["done"],
            "deadline_missed": snap["slo"]["deadline_missed"],
            "deadline_done": snap["slo"]["deadline_done"]}


def fleet(card, params):
    """GPT-2-small at full width and depth behind a two-partition
    ``FleetRouter`` on a ``SimClock``: the reference chaos scenario's trace
    at GPT-2's vocabulary and lengths, partition 0 killed mid-burst and a
    replacement joining; counted on the simulated clock, then timed on the
    card's own."""
    from elephas_tpu_torch.fleet import SimClock
    from elephas_tpu_torch.models import TransformerLM

    model = TransformerLM(**GPT2_SMALL, device="cuda")
    trace = _fleet_trace()
    base_router, base_snap, _ = _fleet_run(model, params, trace, paged=False, chaos=None,
                                           clock=SimClock())
    torch.cuda.synchronize()
    _zero_counters()
    router, snap, made = _fleet_run(model, params, trace, paged=False, chaos=FLEET_CHAOS,
                                    clock=SimClock())
    torch.cuda.synchronize()
    counts, steps, inserts = _fleet_checks("fleet", trace, router, snap, made, False)
    timed = _fleet_wall(model, params, trace, paged=False)
    emit({"phase": "fleet", "model": "gpt2-small (random weights, seed 0)",
          "partitions": 2, "n_slots": FLEET_SLOTS, "trace": FLEET_TRACE,
          "chaos": FLEET_CHAOS, "step_dt_s": FLEET_STEP_DT, "engines_built": len(made),
          "decode_steps": steps, "inserts": inserts, "launches": counts,
          "migrations": router.migrations, **_fleet_summary(snap, trace),
          "undisturbed": _fleet_summary(base_snap, trace), "on_card_time": timed,
          "card": card})
    return model, trace, base_router, router, counts


def fleet_paged(card, model, params, trace):
    """The same trace on paged partitions (page 16), ``kv.check()`` after
    every fleet step, exact K5-decode and K5-chunk counts."""
    from elephas_tpu_torch.fleet import SimClock

    base_router, base_snap, _ = _fleet_run(model, params, trace, paged=True, chaos=None,
                                           clock=SimClock())
    torch.cuda.synchronize()
    _zero_counters()
    router, snap, made = _fleet_run(model, params, trace, paged=True, chaos=FLEET_CHAOS,
                                    clock=SimClock(), check=True)
    torch.cuda.synchronize()
    counts, steps, inserts = _fleet_checks("fleet_paged", trace, router, snap, made, True)
    timed = _fleet_wall(model, params, trace, paged=True)
    emit({"phase": "fleet_paged", "page_size": 16, "engines_built": len(made),
          "decode_steps": steps, "inserts": inserts, "launches": counts,
          "migrations": router.migrations, **_fleet_summary(snap, trace),
          "undisturbed": _fleet_summary(base_snap, trace), "on_card_time": timed,
          "kv_checked_every_step": True, "card": card})
    return base_router, router, counts


def fleet_cross_check(card, model, params, trace, runs):
    """Migrated and surviving streams against the undisturbed run's, dense
    and paged: equal up to each request's first near tie (top-2 gap 1e-3
    or less; for a sampled row, the gap of the scaled logits plus the
    engine's Gumbel noise)."""
    reqs = {r.request_id: r for r in trace}
    out = {}
    for name, (base, chaos) in runs.items():
        want, got = base.results(), chaos.results()
        rows, migrated = [], 0
        for rid, st in want.items():
            req = reqs[rid]
            prompt = np.asarray(req.prompt, np.int32)
            gaps = (_top2_gaps(model, params, prompt, st.tokens) if req.temperature == 0
                    else _noisy_gaps(model, params, prompt, st.tokens, req.seed,
                                     req.temperature))
            a, b = got[rid].tokens, st.tokens
            require(len(a) == len(b), f"{name}: {rid} emitted {len(a)} tokens, want {len(b)}")
            n = 0
            while n < len(b) and gaps[n] > 1e-3:
                require(a[n] == b[n], f"{name}: {rid} position {n}: {a[n]} != {b[n]} "
                                      f"(gap {gaps[n]})")
                n += 1
            migrated += got[rid].migrations > 0
            rows.append({"request": rid, "migrated": got[rid].migrations > 0,
                         "sampled": req.temperature > 0, "compared": n, "of": len(b)})
        require(migrated > 0, f"{name}: no migrated stream to compare")
        out[name] = {"requests_compared": len(rows), "migrated": migrated,
                     "positions_compared": sum(r["compared"] for r in rows),
                     "positions": sum(r["of"] for r in rows),
                     "migrated_rows": [r for r in rows if r["migrated"]]}
    emit({"phase": "fleet_cross_check", **out, "card": card})


def _stream_model():
    from elephas_tpu_torch.models import TransformerLM

    cfg = dict(GPT2_SMALL, n_layers=STREAM_LAYERS)
    model = TransformerLM(**cfg, device="cuda")
    return model, model.init(SEED + 51)


class _ParamsHolder:
    """The LM's params as ``SparkModel``'s master network: the PS wire order
    is the sorted keys (``streaming.bridge``)."""

    def __init__(self, params):
        self.params = dict(params)

    def get_weights(self):
        from elephas_tpu_torch.streaming import params_to_list

        return params_to_list(self.params)

    def set_weights(self, weights):
        from elephas_tpu_torch.streaming import list_to_params

        self.params = list_to_params(weights, self.params)


def _stream_train_fn(model, template, counts, poison=0.5):
    """``train_fn(weights, batch)`` over the port's LM train step
    (``attn="flash"``, ``adam_compact(1e-3)``): the wire list bridged onto
    the card, one step, back to the wire. A ``"poison"`` batch adds seeded
    Gaussian noise of scale ``poison`` to every weight (no step) and
    ``"cure"`` takes the same noise off again. The launches each call made
    are added to ``counts``."""
    from elephas_tpu_torch.models import adam_compact, build_lm_train_step
    from elephas_tpu_torch.streaming import list_to_params, params_to_list

    step, opt_init = build_lm_train_step(model, None, adam_compact(1e-3), attn="flash")
    state = {}

    def train_fn(weights, batch):
        before = _read_counters()
        if isinstance(batch, str):
            sign = 1.0 if batch == "poison" else -1.0
            rng = np.random.default_rng(SEED + 53)
            new = [w + np.float32(sign * poison) * rng.standard_normal(w.shape, np.float32)
                   for w in weights]
            return new, 0.0
        params = list_to_params(weights, template)
        if "opt" not in state:
            state["opt"] = opt_init(params)
        new, state["opt"], loss = step(params, state["opt"], *batch)
        out = params_to_list(new), float(loss)
        after = _read_counters()
        for k in after:
            counts[k] = counts.get(k, 0) + after[k] - before[k]
        counts["steps"] = counts.get("steps", 0) + 1
        return out

    return train_fn


def _stream_eval_fn(model, template, batch):
    from elephas_tpu_torch.models import build_lm_eval_step
    from elephas_tpu_torch.streaming import list_to_params

    ev = build_lm_eval_step(model, None, attn="flash")
    return lambda weights, _b: float(ev(list_to_params(weights, template), *batch))


def _lm_batch(gen, B, T, V):
    from elephas_tpu_torch.models import make_lm_batches

    return tuple(torch.from_numpy(a).cuda() for a in
                 make_lm_batches(gen.integers(0, V, size=(B, T + 1)).astype(np.int32)))


def _probe(eng, model, weights, template, prompt, max_new, n_steps_cap=2000):
    """Serve ``prompt`` on the live engine (other requests keep decoding
    beside it) and on a fresh engine of the published weights: the live
    tokens equal the fresh ones up to the first near tie."""
    from elephas_tpu_torch.serving import ServingEngine
    from elephas_tpu_torch.streaming import list_to_params

    rid = eng.submit(prompt, max_new)
    for _ in range(n_steps_cap):
        if eng.result(rid, pop=False) is not None:
            break
        eng.step()
    fin = eng.result(rid)
    require(fin is not None and fin.finish_reason == "length", "probe did not finish")
    published = list_to_params(weights, template)
    fresh = ServingEngine(model, published, n_slots=1, paged=eng._paged, page_size=16,
                          device="cuda")
    fid = fresh.submit(prompt, max_new)
    want = fresh.drain()[fid].tokens
    compared = _agree("stream probe", model, published, [prompt], [fin.tokens], [want])[0]
    return fin, compared


def stream(card):
    """``SparkModel.fit_stream`` with the port's LM train step at
    GPT-2-small's width (``STREAM_LAYERS`` of its 12 layers) as
    ``train_fn``, over a socket parameter server, publishing every commit
    through ``engine_sink`` into a live paged engine that keeps serving
    between commits; a poisoned update is rolled back by the eval gate; then
    the same through ``router_sink`` into a two-partition fleet."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.fleet import FleetRouter, SimClock, TraceRequest, router_sink
    from elephas_tpu_torch.serving import ServingEngine
    from elephas_tpu_torch.streaming import engine_sink

    L, V = STREAM_LAYERS, GPT2_SMALL["vocab"]
    model, p0 = _stream_model()
    gen = np.random.default_rng(SEED + 52)
    B, T = 4, 512
    batches = [_lm_batch(gen, B, T, V) for _ in range(3)]
    eval_fn = _stream_eval_fn(model, p0, _lm_batch(gen, B, T, V))
    probe = gen.integers(0, V, size=80).astype(np.int32)

    def run(sink, stream_batches):
        counts = {}
        sm = SparkModel(_ParamsHolder(p0), mode="asynchronous",
                        parameter_server_mode="socket", port=0, device="cuda")
        t0 = time.perf_counter()
        summary = sm.fit_stream(stream_batches, _stream_train_fn(model, p0, counts),
                                sink=sink, publish_every=1, eval_fn=eval_fn,
                                regression_margin=0.5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = counts.pop("steps")
        want = {**{k: L * steps for k in ("flash_attention_fwd", "flash_attention_dq",
                                            "flash_attention_dkv")},
                "layer_norm_bwd": (2 * L + 1) * steps}
        for name, n in want.items():
            require(counts[name] == n, f"stream: train_fn launched {name} {counts[name]} "
                                       f"times, want {n} ({steps} steps of L {L})")
        return summary, {k: v for k, v in counts.items() if v}, steps, wall, sm

    # a live paged engine: three long requests decode across every commit
    eng = ServingEngine(model, p0, n_slots=8, paged=True, page_size=16, device="cuda")
    live = [eng.submit(gen.integers(0, V, size=n).astype(np.int32), 400)
            for n in (96, 160, 64)]
    for _ in range(8):
        eng.step()
    log = []

    def sink(weights, version):
        engine_sink(eng, p0)(weights, version)
        require(eng.weights_version == version,
                f"stream: engine at version {eng.weights_version}, published {version}")
        for _ in range(8):                   # serving between commits
            eng.step()
        fin, compared = _probe(eng, model, weights, p0, probe, 16)
        require(set(fin.token_versions) == {version},
                f"stream: probe tokens under versions {set(fin.token_versions)}")
        log.append({"version": version, "probe_compared": compared,
                    "live_active": eng.kv.active_slots,
                    "prefix_nodes": eng.kv.memory_stats()["prefix"]["nodes"]})

    summary, counts, steps, wall, sm = run(sink, [batches[0], batches[1], "poison", "cure",
                                                  batches[2]])
    pub = summary["publisher"]
    events = [r["event"] for r in pub["history"]]
    require(summary["commits"] == 5, f"stream: {summary['commits']} commits for 5 batches")
    require(events == ["publish", "publish", "rollback", "publish", "publish"],
            f"stream: publisher history {events}")
    require([r["version"] for r in pub["history"]] == [1, 2, 2, 4, 5]
            and pub["history"][2]["rejected_version"] == 3,
            f"stream: versions {pub['history']}")
    require([x["version"] for x in log] == [1, 2, 4, 5], f"stream: sink saw {log}")
    require(eng.kv.active_slots >= 1 and any(eng.result(r, pop=False) is None for r in live),
            "stream: the live requests stopped decoding")
    emit({"phase": "stream", "model": f"gpt2-small width, {L} of 12 layers (depth cut; "
                                      f"random weights, seed {SEED + 51})",
          "batch": [B, T], "server": "socket", "commits": summary["commits"],
          "train_steps": steps, "publisher": {k: pub[k] for k in
                                               ("published", "rollbacks", "serving_version")},
          "history": pub["history"], "sink": log, "train_fn_launches": counts,
          "wall_s": wall, "s_per_commit": wall / summary["commits"],
          "weights_mb": sum(w.nbytes for w in sm.master_network.get_weights()) / 1e6,
          "card": card})

    # the same through router_sink into a two-partition fleet
    clock = SimClock()
    router = FleetRouter(lambda pid: ServingEngine(model, p0, n_slots=8, paged=True,
                                                   page_size=16, clock=clock,
                                                   perf_clock=clock, device="cuda"),
                         2, clock=clock)
    for i in range(4):
        router.submit(TraceRequest(f"s{i}", 0.0, i % 2,
                                   gen.integers(0, V, size=64).tolist(), 300))
    for _ in range(6):
        router.step()
    flog = []

    def fleet_sink(weights, version):
        router_sink(router, p0)(weights, version)
        versions = [router._engines[p].weights_version for p in router.partition_ids()]
        require(versions == [version] * 2, f"stream_fleet: partitions at {versions}")
        for _ in range(6):
            router.step()
        fin, compared = _probe(router._engines[router.partition_ids()[0]], model, weights,
                               p0, probe, 16)
        flog.append({"version": version, "partition_versions": versions,
                     "probe_compared": compared})

    fsummary, fcounts, fsteps, fwall, _ = run(fleet_sink, batches[:2])
    require(fsummary["commits"] == 2 and [x["version"] for x in flog] == [1, 2],
            f"stream_fleet: {fsummary['commits']} commits, sink saw {flog}")
    emit({"phase": "stream_fleet", "partitions": 2, "commits": fsummary["commits"],
          "sink": flog, "train_fn_launches": fcounts, "wall_s": fwall, "card": card})
    return counts


RES_FIT = dict(samples=8192, batch=128, workers=2, epochs=2, validation_split=0.1)


def _host_fault_fit(what, sm, x, y, want_fwd, want_bwd, workers=None):
    """One host-path fit under resilience options over ``workers``
    partitions (``RES_FIT``'s by default), the launch counts set to 0 just
    before and read just after: exact K1 counts (from the worker threads),
    no other kernel, finite weights."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.utils import to_simple_rdd

    c = RES_FIT
    workers = c["workers"] if workers is None else workers
    rdd = to_simple_rdd(SparkContext(f"local[{workers}]"), x, y, num_slices=workers)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    sm.fit(rdd, epochs=c["epochs"], batch_size=c["batch"],
           validation_split=c["validation_split"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters()
    want = {"fused_xent_fwd": want_fwd, "fused_xent_bwd": want_bwd}
    for name, n in want.items():
        require(counts[name] == n, f"{what}: {name} launched {counts[name]} times, want {n}")
    others = {k: v for k, v in counts.items() if k not in want and v}
    require(not others, f"{what}: other kernels launched: {others}")
    for w in sm.master_network.get_weights():
        require(bool(np.isfinite(w).all()) and float(np.abs(w).max()) < 1e3,
                f"{what}: non-finite or runaway weights")
    return wall, counts


def resilience_fit(card):
    """The MLP fit on the card under the resilience options: (a) the host
    path under a ``FaultPlan`` (dropped pushes, partition 1 crashed after
    its first push, partition 0 a straggler) with a ``RetryPolicy``; (b) a
    hot standby on the socket server with the primary killed mid-fit; (c) a
    ``HeartbeatRegistry`` quorum on the compiled path, one worker expired."""
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.resilience import (FaultPlan, HeartbeatRegistry,
                                              QuorumLostError, RetryPolicy)
    from elephas_tpu_torch.resilience.faults import _unit
    from elephas_tpu_torch.utils import to_simple_rdd

    c = RES_FIT
    (x, y), _ = mnist_like(c["samples"], 16)
    W, E = c["workers"], c["epochs"]
    S, Sv = _host_steps(len(x), W, c["batch"], c["validation_split"], "epoch")
    retry = RetryPolicy(max_attempts=4, base_delay_s=0.01, max_delay_s=0.05)
    out = {}

    # (a) partition 1 crashes at its second push (after two epochs' work)
    # and its retry trains E epochs again: (W E + E) epochs of K1
    rate, opportunities = 0.25, W * E + 1
    seed = next(s for s in range(100)
                if sum(_unit(s, "drop_push", n) < rate for n in range(opportunities)) >= 1)
    drops = sum(_unit(seed, "drop_push", n) < rate for n in range(opportunities))
    plan = FaultPlan(seed, drop_push=rate, crash_partition=1, crash_after_pushes=1,
                     straggler_stalls={0: 0.5})
    sm = _mlp_model(num_workers=W, port=0, parameter_server_mode="socket",
                    fault_plan=plan, retry_policy=retry)
    wall, counts = _host_fault_fit("resilience_fit host", sm, x, y, (W * E + E) * (S + Sv),
                                   (W * E + E) * S)
    ps = sm.membership_snapshot()["parameter_servers"]["primary"]
    require("crash-partition-1" in plan.fired and "straggle-partition-0" in plan.fired,
            f"resilience_fit host: fired {plan.fired}")
    # every push that was not dropped applied exactly once, none twice
    require(ps["version"] == opportunities - drops and ps["rejected_stale"] == 0,
            f"resilience_fit host: server version {ps['version']}, want "
            f"{opportunities} pushes - {drops} dropped")
    out["host"] = {"wall_s": wall, "launches": counts, "fired": plan.fired,
                   "server": ps, "drops": drops, "pushes": opportunities}

    # (b) hot standby, the primary killed at its 9th request
    plan = FaultPlan(seed=5, crash_sites={"kill-primary": 8})
    registry = HeartbeatRegistry(lease_s=120.0)
    sm = _mlp_model(num_workers=W, port=0, parameter_server_mode="socket",
                    fault_plan=plan, retry_policy=retry, hot_standby=True,
                    membership=registry)
    wall, counts_b = _host_fault_fit("resilience_fit standby", sm, x, y,
                                     W * E * (S + Sv), W * E * S)
    snap = sm.membership_snapshot()
    ps = snap["parameter_servers"]
    require("kill-primary" in plan.fired and snap["counters"].get("failovers", 0) >= 1,
            f"resilience_fit standby: fired {plan.fired}, counters {snap['counters']}")
    require(ps["standby"]["version"] >= ps["primary"]["version"] > 0
            and ps["primary"]["replication_errors"] == 0,
            f"resilience_fit standby: servers {ps}")
    out["standby"] = {"wall_s": wall, "launches": counts_b, "servers": ps,
                      "failovers": snap["counters"]["failovers"]}

    # (c) the compiled path, worker 3 of 4 expired: masked out of the merges
    registry = HeartbeatRegistry(lease_s=120.0, clock=lambda: 0.0)
    Wc = 4
    rdd = to_simple_rdd(SparkContext(f"local[{Wc}]"), x, y, num_slices=Wc)
    Sc, Svc = _mlp_steps(len(x), Wc, c["batch"], c["validation_split"])
    plain = _mlp_model(mode="synchronous", num_workers=Wc, dropout=False)
    w0 = plain.master_network.get_weights()
    plain.fit(rdd, epochs=E, batch_size=c["batch"], validation_split=c["validation_split"])
    sm = _mlp_model(mode="synchronous", num_workers=Wc, dropout=False,
                    membership=registry, quorum=3)
    sm.master_network.set_weights(w0)
    registry.join("partition-3")
    registry.expire("partition-3")
    require(sm._membership_mask(Wc) == [1.0, 1.0, 1.0, 0.0],
            f"resilience_fit quorum: mask {sm._membership_mask(Wc)}")
    wall, counts_c, hist = _compiled_fit("resilience_fit quorum", sm, rdd, E, c["batch"],
                                         c["validation_split"], Sc, Svc)
    moved = max(float(np.abs(a - b).max()) for a, b in
                zip(sm.master_network.get_weights(), plain.master_network.get_weights()))
    require(moved > 0, "resilience_fit quorum: the excluded worker changed nothing")
    registry.join("partition-2")
    registry.expire("partition-2")
    try:
        sm._membership_mask(Wc)
        require(False, "resilience_fit quorum: 2 of 4 live passed quorum 3")
    except QuorumLostError:
        pass
    out["quorum"] = {"wall_s": wall, "launches": counts_c, "mask": [1, 1, 1, 0],
                     "max_weight_diff_vs_all_workers": moved, "loss": hist["loss"]}
    emit({"phase": "resilience_fit", "samples": c["samples"], "workers": W, "epochs": E,
          "S": S, "Sv": Sv, **out, "card": card})
    return {"resilience_fit_host": counts, "resilience_fit_standby": counts_b,
            "resilience_fit_quorum": counts_c}


def soak(card):
    """``run_soak`` on the card: five seeded schedules, one of each stack
    (the synchronous fit with a killed worker, the asynchronous and hogwild
    fits under the wire and logical storm, ``fit_stream`` twice for the
    replay's bit-identity, the paged fleet replay with a kill and a join)."""
    from elephas_tpu_torch.resilience import run_soak

    t0 = time.perf_counter()
    report = run_soak(n_schedules=5, base_seed=0, device="cuda")
    wall = time.perf_counter() - t0
    require(not report["failures"], f"soak: {report['failures']}")
    require(report["completed"] + report["typed_failures"] == 5, f"soak: {report}")
    emit({"phase": "soak", "schedules": 5, "completed": report["completed"],
          "typed_failures": report["typed_failures"],
          "runs": [{k: r.get(k) for k in ("scenario", "seed", "outcome", "fired",
                                          "wire_caught", "migrations", "error")}
                   for r in report["runs"]], "wall_s": wall, "card": card})


# -- the card runs of options ported earlier (ROADMAP §3 open gap 3) ----------------


AUTOSCALER_TRACE = dict(FLEET_TRACE, duration_s=6.0)


def fleet_autoscaler(card, model, params):
    """``fleet``'s traffic model over 6 s (``AUTOSCALER_TRACE``) through a
    GPT-2-small fleet that starts at one partition of 2 slots under an
    ``Autoscaler`` (1 to 4 partitions,
    cooldown 1 s, queue high-water 3 a partition) on a ``SimClock``: it
    scales up under the load and down after it; every request terminal;
    exact launches over every engine built."""
    from elephas_tpu_torch.fleet import (Autoscaler, FleetRouter, SimClock, TrafficModel,
                                         run_trace)
    from elephas_tpu_torch.serving import ServingEngine

    trace = TrafficModel(**AUTOSCALER_TRACE).generate()
    clock = SimClock()
    made = []

    def factory(pid):
        eng = ServingEngine(model, params, n_slots=2, clock=clock, perf_clock=clock,
                            device="cuda")
        made.append(eng)
        return eng

    router = FleetRouter(factory, 1, clock=clock, lease_s=2.0)
    scaler = Autoscaler(router, min_partitions=1, max_partitions=4, cooldown_s=1.0,
                        queue_high=3.0)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    snap = run_trace(router, trace, clock=clock, step_dt=FLEET_STEP_DT, autoscaler=scaler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, steps, inserts = _fleet_checks("fleet_autoscaler", trace, router, snap, made,
                                           False, migrated=False)
    actions = [e["action"] for e in scaler.events]
    require("up" in actions, f"fleet_autoscaler: no scale-up under the load: {scaler.events}")
    emit({"phase": "fleet_autoscaler", "model": "gpt2-small (random weights, seed 0)",
          "start_partitions": 1, "n_slots": 2, "trace": AUTOSCALER_TRACE,
          "events": scaler.events, "actions": actions, "engines_built": len(made),
          "live_at_end": router.n_live, "decode_steps": steps, "inserts": inserts,
          "launches": counts, "migrations": router.migrations,
          **_fleet_summary(snap, trace), "wall_s": wall, "card": card})
    return counts


def stream_supervised(card):
    """``fit_stream`` with ``checkpoint_dir`` (it runs under
    ``TrainingSupervisor``): the ``stream`` phase's train step over three
    batches, the second call of ``train_fn`` crashing once; the supervisor
    resumes from the checkpoint's cursor, so three commits land (each batch
    once), the checkpoint holds the server's final weights, and the train
    steps launch exactly L K2-fwd, dq and dkv and 2L+1 K3-bwd each."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.utils import load_checkpoint

    L, V = STREAM_LAYERS, GPT2_SMALL["vocab"]
    model, p0 = _stream_model()
    gen = np.random.default_rng(SEED + 55)
    batches = [_lm_batch(gen, 4, 512, V) for _ in range(3)]
    counts, calls = {}, []
    inner = _stream_train_fn(model, p0, counts)

    def train_fn(weights, batch):
        calls.append(len(calls))
        if len(calls) == 2:
            raise RuntimeError("injected crash before the second commit")
        return inner(weights, batch)

    sm = SparkModel(_ParamsHolder(p0), mode="asynchronous", parameter_server_mode="socket",
                    port=0, device="cuda")
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        summary = sm.fit_stream(batches, train_fn, checkpoint_dir=ckpt, checkpoint_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        weights, meta, _ = load_checkpoint(ckpt)
    steps = counts.pop("steps")
    require(summary["commits"] == 3 and len(calls) == 4 and steps == 3,
            f"stream_supervised: {summary['commits']} commits, {len(calls)} train_fn "
            f"calls, {steps} steps")
    require(meta["stream"]["batches_done"] == 3 and meta["stream"]["commits"] == 3,
            f"stream_supervised: checkpoint {meta}")
    require(all(np.array_equal(a, b) for a, b in
                zip(weights, sm.master_network.get_weights())),
            "stream_supervised: the checkpoint is not the final weights")
    want = {**{k: L * steps for k in ("flash_attention_fwd", "flash_attention_dq",
                                        "flash_attention_dkv")},
            "layer_norm_bwd": (2 * L + 1) * steps}
    for name, n in want.items():
        require(counts[name] == n, f"stream_supervised: train_fn launched {name} "
                                   f"{counts[name]} times, want {n}")
    emit({"phase": "stream_supervised", "model": f"gpt2-small width, {L} of 12 layers",
          "batches": 3, "commits": summary["commits"], "train_fn_calls": len(calls),
          "crashes": 1, "checkpoint": meta["stream"], "train_fn_launches":
          {k: v for k, v in counts.items() if v}, "wall_s": wall, "card": card})
    return {k: v for k, v in counts.items() if v}


def round_options_fit(card):
    """The MLP fit's synchronous host path (``comm="host"``) on the card
    under a ``HeartbeatRegistry`` with the round options: (a)
    ``round_deadline_s=0.5``, quorum 3 of 4, partition 3 stalled until the
    round has committed (its attempt then fails, so it never trains): three
    deltas merge, exact K1 counts of three workers; (b)
    ``backup_stragglers=False``, 2 workers, stragglers flagged after 0.2 s
    and partition 1 stalled 1 s: no backup, both deltas merge, exact K1
    counts of two workers."""
    from elephas_tpu_torch.resilience import FaultPlan, HeartbeatRegistry

    c = RES_FIT
    (x, y), _ = mnist_like(c["samples"], 16)
    E, split = c["epochs"], c["validation_split"]
    out, paths = {}, {}

    release = threading.Event()

    def stall(_seconds):
        release.wait(120.0)
        raise RuntimeError("the abandoned attempt ends here")

    W = 4
    S, Sv = _host_steps(len(x), W, c["batch"], split, "epoch")
    plan = FaultPlan(seed=0, straggler_stalls={3: 1.0}, sleep=stall)
    registry = HeartbeatRegistry(lease_s=120.0)
    sm = _mlp_model(mode="synchronous", comm="host", num_workers=W, port=0, fault_plan=plan,
                    membership=registry, quorum=3, round_deadline_s=0.5)
    try:
        wall, counts = _host_fault_fit("round_deadline", sm, x, y, 3 * E * (S + Sv),
                                       3 * E * S, workers=W)
    finally:
        release.set()
    last = sm.membership_snapshot()["rounds"][-1]
    require(last["received"] == 3 and last["deadline_hit"] is True
            and not registry.is_live("partition-3"),
            f"round_deadline: round {last}")
    out["round_deadline"] = {"workers": W, "quorum": 3, "round_deadline_s": 0.5,
                             "wall_s": wall, "launches": counts, "round": last}
    paths["round_deadline_fit"] = counts

    W = 2
    S, Sv = _host_steps(len(x), W, c["batch"], split, "epoch")
    plan = FaultPlan(seed=0, straggler_stalls={1: 1.0})
    registry = HeartbeatRegistry(lease_s=120.0, straggler_after_s=0.2)
    sm = _mlp_model(mode="synchronous", comm="host", num_workers=W, port=0, fault_plan=plan,
                    membership=registry, backup_stragglers=False)
    wall, counts = _host_fault_fit("no_backup", sm, x, y, W * E * (S + Sv), W * E * S,
                                   workers=W)
    last = sm.membership_snapshot()["rounds"][-1]
    require(last["received"] == 2 and last["backups"] == 0
            and "backup" not in sm.membership_snapshot()["counters"],
            f"no_backup: round {last}")
    out["no_backup"] = {"workers": W, "straggler_after_s": 0.2, "stall_s": 1.0,
                        "wall_s": wall, "launches": counts, "round": last}
    paths["no_backup_fit"] = counts
    emit({"phase": "round_options_fit", "samples": c["samples"], "epochs": E, **out,
          "card": card})
    return paths


# -- elastic hosts, the native loader, quantization and the import (items 10, 12) ----

ELASTIC_FIT = dict(samples=16384, batch=128, rounds=6, workers=4)
ELASTIC_TRACE = [("join", "host-0"), ("join", "host-1"), ("join", "host-2"),
                 ("join", "host-3"), ("expire", "host-1")]
ELASTIC_CONTRIBUTORS = [(0, 1), (0, 1), (0, 1, 2), (0, 1, 2, 3), (0, 2, 3), (0, 2, 3)]


# The hosts' task in ``fit_elastic``, written to a file and loaded by path in
# each host process (a ``{"file", "fn"}`` task): the port's
# ``keras_fit_task``, with the kernel launches this process made during the
# round, the replica's device and the round's seconds added to its metrics.
# It imports nothing heavy until it runs: a host resolves its task when it
# is adopted, before it reads its first round, and a slow import there
# would hold the driver's send of that round past the host's lease.
ELASTIC_TASK = """
import os
import sys
import time

ROOT = {root!r}


def counted_keras_fit_task(weights, shard, config):
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from elephas_tpu_torch.parallel import emulation
    import chip_smoke

    before = chip_smoke._read_counters()
    t0 = time.perf_counter()
    delta, metrics = emulation.keras_fit_task(weights, shard, config)
    (replica,) = emulation._KERAS_CACHE.values()
    if replica.device.type == "cuda":
        torch.cuda.synchronize(replica.device)
    after = chip_smoke._read_counters()
    metrics.update(launches={{k: after[k] - before[k] for k in after if after[k] != before[k]}},
                   device=str(replica.device), round_s=time.perf_counter() - t0,
                   pid=os.getpid())
    return delta, metrics
"""


class _StampedQueue(queue.Queue):
    """The pool's control queue, stamping each host's hello and each
    contribution (with its metrics) on the registry's clock as the reader
    thread hands it over."""

    def __init__(self, clock):
        super().__init__()
        self.clock = clock
        self.hellos = {}
        self.arrivals = []

    def put(self, item, *args, **kwargs):
        op, host, msg = item
        if op == "hello":
            self.hellos.setdefault(host, self.clock())
        elif op == "contrib":
            self.arrivals.append({"host": host, "epoch": int(msg["epoch"]),
                                  "round": int(msg["round"]), "at": self.clock(),
                                  "metrics": msg["metrics"]})
        super().put(item, *args, **kwargs)


@contextlib.contextmanager
def _counting_pools():
    """``SparkModel``'s elastic fits build a pool whose hosts run
    ``ELASTIC_TASK`` and whose spawns, hellos and contributions are
    stamped (and each host's first round as it is sent); yields the list of
    pools built."""
    from elephas_tpu_torch.parallel import elastic

    built = []
    base = elastic.ElasticHostPool
    tmp = tempfile.TemporaryDirectory()
    task_file = os.path.join(tmp.name, "counted_task.py")
    with open(task_file, "w") as f:
        f.write(ELASTIC_TASK.format(root=os.path.dirname(os.path.abspath(__file__))))

    class CountingPool(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            require(self.task == {"builtin": "keras_fit_task"},
                    f"fit_elastic: SparkModel's task is {self.task}")
            self.task = {"file": task_file, "fn": "counted_keras_fit_task"}
            self._queue = _StampedQueue(self.registry.clock)
            self.spawned, self.first_round = {}, {}
            built.append(self)

        def _spawn(self, host_id, at_round):
            self.spawned[host_id] = self.registry.clock()
            super()._spawn(host_id, at_round)

        def _send(self, host_id, msg):
            if msg["op"] == "round":
                self.first_round.setdefault(host_id, self.registry.clock())
            return super()._send(host_id, msg)

    elastic.ElasticHostPool = CountingPool
    try:
        yield built
    finally:
        elastic.ElasticHostPool = base
        tmp.cleanup()


def _zombie_partition(card):
    """The reference's zombie-partition scenario with ``sgd_task`` hosts
    (3 hosts, host 2's heartbeat channel cut at round 1, lease 1.5 s): its
    delta is rejected by the server's fence, the trace and commits are the
    reference's pins."""
    from elephas_tpu_torch.parallel import ElasticConfig, ElasticHostPool
    from elephas_tpu_torch.resilience import FaultPlan

    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 3))
    y = x @ np.array([1.0, -2.0, 3.0])
    plan = FaultPlan(seed=3, partition_hosts={1: 2})
    pool = ElasticHostPool([np.zeros(3)], ElasticConfig(initial_hosts=3, rounds=3,
                                                         lease_s=1.5, beat_interval_s=0.1),
                           task={"builtin": "sgd_task"},
                           task_config={"lr": 0.5, "sleep_s": 0.1}, fault_plan=plan)
    t0 = time.perf_counter()
    pool.fit(x, y)
    wall = time.perf_counter() - t0
    require(pool.membership_trace == ELASTIC_TRACE[:3] + [("expire", "host-2")],
            f"elastic zombie: trace {pool.membership_trace}")
    require(pool.ps.rejected_stale == 1 and pool.stats["rejected_stale"] == 1
            and [c["version"] for c in pool.commit_log] == [1, 2, 3],
            f"elastic zombie: stats {pool.stats}, commits {pool.commit_log}")
    return {"wall_s": wall, "stats": pool.stats, "trace": pool.membership_trace,
            "fired": plan.fired}


def fit_elastic(card):
    """The pinned elastic scenario on the card: ``SparkModel(elastic=
    ElasticConfig(initial_hosts=2, scale_schedule={2: 4}, ...))`` over the
    committed MLP JSON at full width, 16384 samples, batch 128, 6 rounds,
    ``FaultPlan(seed=1234, kill_hosts={4: 1}, join_delay_rounds={3: 1})``:
    2→3→4→3 hosts, the reference's pins (trace, mesh sizes, versions,
    contributors, one re-formation, three discarded deltas, nothing stale),
    falling losses; every committed contribution ran on ``cuda`` and
    launched K1-fwd and K1-bwd exactly its shard's step count, and no other
    kernel (counted in the host processes); host boot times, the time to
    recover (the expiry → the next commit, on the registry's clock), round
    walls and samples/s; then the zombie-partition scenario with
    ``sgd_task``."""
    from elephas_tpu_torch import SparkModel
    from elephas_tpu_torch.data import SparkContext
    from elephas_tpu_torch.parallel import ElasticConfig
    from elephas_tpu_torch.resilience import FaultPlan
    from elephas_tpu_torch.utils import to_simple_rdd

    c = ELASTIC_FIT
    (x, y), _ = mnist_like(c["samples"], 16)
    rdd = to_simple_rdd(SparkContext(f"local[{c['workers']}]"), x, y,
                        num_slices=c["workers"])
    plan = FaultPlan(seed=1234, kill_hosts={4: 1}, join_delay_rounds={3: 1})
    sm = _mlp_model(num_workers=c["workers"], batch_size=c["batch"], fault_plan=plan,
                    elastic=ElasticConfig(initial_hosts=2, scale_schedule={2: 4},
                                          min_hosts=1, lease_s=4.0, beat_interval_s=0.2,
                                          round_timeout_s=180.0, quiet_workers=False))
    with _counting_pools() as built:
        t0 = time.perf_counter()
        sm.fit(rdd, epochs=c["rounds"], batch_size=c["batch"], validation_split=0.0)
        wall = time.perf_counter() - t0
    (pool,) = built
    require(sm._elastic_pool is pool, "fit_elastic: the pool is not SparkModel's")
    losses = pool.history["loss"]
    require(len(losses) == c["rounds"] and losses[-1] < losses[0],
            f"fit_elastic: losses {losses}")
    require(pool.membership_trace == ELASTIC_TRACE,
            f"fit_elastic: trace {pool.membership_trace}")
    require(plan.fired.get("kill-host-1") == 4 and plan.fired.get("delay-join-host-3") == 1,
            f"fit_elastic: fired {plan.fired}")
    require([m["num_hosts"] for m in pool.mesh_history] == [2, 3, 4, 3],
            f"fit_elastic: meshes {pool.mesh_history}")
    log = pool.commit_log
    require([e["version"] for e in log] == list(range(1, c["rounds"] + 1))
            and pool.ps.version == c["rounds"], f"fit_elastic: versions {log}")
    require([e["epoch"] for e in log] == sorted(e["epoch"] for e in log),
            "fit_elastic: epochs not monotonic")
    require([tuple(e["contributors"]) for e in log] == ELASTIC_CONTRIBUTORS,
            f"fit_elastic: contributors {[e['contributors'] for e in log]}")
    require(pool.stats["reformations"] == 1 and pool.stats["discarded_reformation"] == 3
            and pool.ps.rejected_stale == 0, f"fit_elastic: stats {pool.stats}")
    snap = sm.membership_snapshot()
    hist = sm.training_histories[-1]
    require(snap["elastic"]["stats"]["rounds_committed"] == c["rounds"]
            and hist["mode"] == "elastic" and hist["reformations"] == 1
            and hist["loss"] == losses, f"fit_elastic: history {hist}")
    arrivals = pool._queue.arrivals
    total = collections.Counter()
    for e in log:
        for h in e["contributors"]:
            (a,) = [a for a in arrivals if (a["host"], a["epoch"], a["round"])
                    == (h, e["epoch"], e["round"])]
            m = a["metrics"]
            steps = -(-m["samples"] // c["batch"])
            require(m["device"].startswith("cuda"),
                    f"fit_elastic: host {h} round {e['round']} ran on {m['device']}")
            require(m["launches"] == {"fused_xent_fwd": steps, "fused_xent_bwd": steps},
                    f"fit_elastic: host {h} round {e['round']} launched {m['launches']}, "
                    f"want {steps} K1-fwd and K1-bwd")
            total.update(m["launches"])
    hellos = pool._queue.hellos
    boot = {h: {"spawn_to_hello_s": hellos[h] - pool.spawned[h],
                "hello_to_first_contribution_s":
                    min(a["at"] for a in arrivals if a["host"] == h) - hellos[h],
                "first_round_sent_to_contribution_s":
                    min(a["at"] for a in arrivals if a["host"] == h) - pool.first_round[h]}
            for h in sorted(pool.spawned)}
    events = pool.registry.snapshot()["events"]
    (expiry,) = [ev for ev in events if ev["kind"] == "expire"]
    recovered = min(e["at"] for e in log if e["at"] > expiry["at"])
    starts = [pool.spawned[0]] + [e["at"] for e in log[:-1]]
    rounds = [{"round": e["round"], "hosts": len(e["contributors"]), "wall_s": e["at"] - s,
               "samples_per_s": c["samples"] / (e["at"] - s), "loss": e["loss"]}
              for e, s in zip(log, starts)]
    zombie = _zombie_partition(card)
    emit({"phase": "fit_elastic", "model": MNIST_JSON, "samples": c["samples"],
          "batch": c["batch"], "rounds": c["rounds"], "trace": pool.membership_trace,
          "mesh_hosts": [m["num_hosts"] for m in pool.mesh_history],
          "commits": [{k: e[k] for k in ("version", "epoch", "round", "contributors", "loss")}
                      for e in log],
          "stats": pool.stats, "fired": plan.fired, "launches": dict(total),
          "boot": boot, "time_to_recover_s": recovered - expiry["at"],
          "round_walls": rounds, "wall_s": wall,
          "host_round_s": [{"host": a["host"], "round": a["round"],
                            "s": a["metrics"]["round_s"]} for a in arrivals],
          "zombie_partition_sgd": zombie, "card": card})
    return dict(total)


def native_loader_phase(card):
    """``NativeBatchLoader`` (``native/data_loader.cpp`` built here by
    ``make``) over 65536 x 784 float32 rows, batch 128, 4 slots, 2
    threads: one epoch holds every row exactly once with its label, the
    same seed gives the same batches, another seed other ones; batches/s of
    the loader alone and with each batch copied to the card."""
    from elephas_tpu_torch.data import NativeBatchLoader

    n, d, B = 65536, 784, 128
    rng = np.random.default_rng(SEED + 71)
    x = rng.random((n, d), dtype=np.float32)
    x[:, 0] = np.arange(n, dtype=np.float32)          # the row id, exact in float32
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=n)]
    t0 = time.perf_counter()
    dl = NativeBatchLoader(x, y, batch_size=B, n_prefetch=4, n_threads=2)
    open_s = time.perf_counter() - t0
    try:
        def epoch(seed, to_card=False):
            ids, t0 = [], time.perf_counter()
            for xb, yb in dl.epoch(seed=seed):
                if to_card:
                    torch.from_numpy(xb).to("cuda")
                    torch.from_numpy(yb).to("cuda")
                ids.append(xb[:, 0].astype(np.int64))
                require(np.array_equal(yb, y[ids[-1]]), "native_loader: a label moved")
            if to_card:
                torch.cuda.synchronize()
            return ids, time.perf_counter() - t0

        a, wall = epoch(7)
        require(np.array_equal(np.sort(np.concatenate(a)), np.arange(n)),
                "native_loader: the epoch is not a permutation of the rows")
        require(len(a) == -(-n // B), f"native_loader: {len(a)} batches")
        b, wall_b = epoch(7)
        other, _ = epoch(8)
        require(all(np.array_equal(p, q) for p, q in zip(a, b)),
                "native_loader: seed 7 twice gave other batches")
        require(any(not np.array_equal(p, q) for p, q in zip(a, other)),
                "native_loader: seeds 7 and 8 gave the same batches")
        _, wall_card = epoch(9, to_card=True)
    finally:
        dl.close()
    emit({"phase": "native_loader", "rows": n, "features": d, "batch": B, "batches": len(a),
          "open_s": open_s, "epoch_s": [wall, wall_b],
          "batches_per_s": len(a) / min(wall, wall_b),
          "rows_per_s": n / min(wall, wall_b), "epoch_to_card_s": wall_card,
          "batches_per_s_to_card": len(a) / wall_card, "card": card})


QUANT_LAYERS = 4


def _quant_run(model, params, prompts, max_new, paged):
    """One counted greedy run of ``prompts`` through ``ServingEngine(n_slots=8,
    max_len=MT_MAX_LEN)``, dense or paged (pages of 16), launch counts set to
    0 just before and read just after: ``(tokens, counts, steps, inserts,
    stats)``."""
    from elephas_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, params, n_slots=8, max_len=MT_MAX_LEN, device="cuda",
                        **(dict(paged=True, page_size=16) if paged else {}))
    torch.cuda.synchronize()
    _zero_counters()
    fin, wall = _drain(eng, prompts, max_new)
    counts = _read_counters()
    snap = eng.snapshot()
    if paged:
        eng.kv.check()
    return ([f.tokens for f in fin], counts, snap["engine"]["decode_steps"],
            snap["engine"]["prefills"], _serving_stats(snap, fin, wall))


def _want_counts(what, counts, want):
    for name, n in counts.items():
        require(n == want.get(name, 0), f"{what}: {name} launched {n} times, want "
                                        f"{want.get(name, 0)}")


def serve_quantized(card):
    """int8 weight-only serving on the card: Llama-3-8B widths at 4 of 32
    layers (random weights drawn on the card, seed 61), ``quantize_lm_params``,
    the ``serve`` mix's 16 prompt lengths over Llama-3's vocabulary, 32 greedy
    new tokens, dense and paged, each on the quantized params and on
    ``dequantize_params`` of them: the streams equal bit for bit, exactly L
    K4 a decode step (dense) or L K5-decode a step and L K5-chunk an insert
    (paged), nothing else; the weights' bytes against float32 and ms a
    decode step of both. Then Mixtral-8x7B widths at 4 layers (``serve_moe``'s
    model, weights seed 20) quantized, 8 of its prompts, 16 new tokens:
    equal to the dequantized model's, exactly 3L K6-gmm a decode step and
    an insert and L K4 a step."""
    from elephas_tpu_torch.models import (MoETransformerLM, TransformerLM,
                                          dequantize_params, quantize_lm_params,
                                          quantized_nbytes)

    L = QUANT_LAYERS
    model = TransformerLM(**dict(LLAMA3_8B, n_layers=L), device="cuda")
    params = draw_params(model, SEED + 61)
    float_bytes = sum(v.nbytes for v in params.values())
    t0 = time.perf_counter()
    q = quantize_lm_params(params)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    del params
    dq = dequantize_params(q)
    prompts = _llama_prompts()
    _quant_run(model, q, [p[:32] for p in prompts[:2]], 4, False)       # warm-up
    out, paths = {}, {}
    for paged in (False, True):
        name = "serve_quantized_paged" if paged else "serve_quantized"
        runs = {k: _quant_run(model, p, prompts, MT_NEW, paged)
                for k, p in (("quantized", q), ("dequantized", dq))}
        for k, (_, counts, steps, inserts, _) in runs.items():
            _want_counts(f"{name} {k}", counts,
                         {"paged_flash_decode_lse": L * steps, "paged_flash_chunk": L * inserts}
                         if paged else {"flash_decode_lse": L * steps})
        tq, cq, steps, inserts, sq = runs["quantized"]
        td, _, _, _, sd = runs["dequantized"]
        require(tq == td, f"{name}: quantized and dequantized streams differ")
        out[name] = {"decode_steps": steps, "inserts": inserts, "launches": cq,
                     "quantized": sq, "dequantized": sd,
                     "decode_ms_ratio_quantized_to_float":
                         sq["decode_ms_per_step_p50"] / sd["decode_ms_per_step_p50"]}
        paths[name] = cq
    weights = {"float32_bytes": float_bytes, "quantized_bytes": quantized_nbytes(q),
               "ratio": quantized_nbytes(q) / float_bytes, "quantize_s": quantize_s}
    del q, dq
    torch.cuda.empty_cache()

    moe = MoETransformerLM(**dict(MIXTRAL_8X7B, n_layers=MOE_SERVE_LAYERS), device="cuda")
    mparams = draw_params(moe, SEED + 20)
    m_float = sum(v.nbytes for v in mparams.values())
    mq = quantize_lm_params(mparams)
    del mparams
    mdq = dequantize_params(mq)
    gen = np.random.default_rng(SEED + 21)
    V = MIXTRAL_8X7B["vocab"]
    mprompts = [gen.integers(0, V, size=int(n)).astype(np.int32)
                for n in gen.integers(32, 257, size=16)][:8]
    tq, cq, steps, inserts, sq = _quant_run(moe, mq, mprompts, 16, False)
    td, _, _, _, sd = _quant_run(moe, mdq, mprompts, 16, False)
    require(tq == td, "serve_moe_quantized: quantized and dequantized streams differ")
    Lm = MOE_SERVE_LAYERS
    _want_counts("serve_moe_quantized", cq, {"gmm": 3 * Lm * (steps + inserts),
                                             "flash_decode_lse": Lm * steps})
    out["serve_moe_quantized"] = {
        "decode_steps": steps, "inserts": inserts, "launches": cq, "quantized": sq,
        "dequantized": sd, "float32_bytes": m_float, "quantized_bytes": quantized_nbytes(mq)}
    paths["serve_moe_quantized"] = cq
    del mq, mdq
    torch.cuda.empty_cache()
    emit({"phase": "serve_quantized", "model": f"Llama-3-8B widths, {L} of 32 layers "
          "(random weights, seed 61); Mixtral-8x7B widths, 4 of 32 layers (seed 20)",
          "requests": len(prompts), "new_tokens_each": MT_NEW, "max_len": MT_MAX_LEN,
          "weights": weights, **out, "card": card})
    return paths


GPT2_HF_CONFIG = dict(model_type="gpt2", activation_function="gelu_new", n_layer=12,
                      n_embd=768, n_head=12, n_inner=None, n_positions=1024,
                      vocab_size=50257, layer_norm_epsilon=1e-5, scale_attn_weights=True,
                      scale_attn_by_inverse_layer_idx=False)


def _gpt2_state_dict(cfg, seed):
    """A GPT-2 ``state_dict`` in Hugging Face's names and layouts (``Conv1D``
    weights ``[in, out]``, the tied ``lm_head``), seeded N(0, 0.02) weights
    and biases, unit norm scales, on the host as a loaded checkpoint is."""
    gen = torch.Generator().manual_seed(seed)
    D, V, P, L = cfg.n_embd, cfg.vocab_size, cfg.n_positions, cfg.n_layer

    def w(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    sd = {"transformer.wte.weight": w(V, D), "transformer.wpe.weight": w(P, D),
          "transformer.ln_f.weight": torch.ones(D), "transformer.ln_f.bias": w(D)}
    for i in range(L):
        pre = f"transformer.h.{i}."
        sd.update({pre + "ln_1.weight": torch.ones(D), pre + "ln_1.bias": w(D),
                   pre + "attn.c_attn.weight": w(D, 3 * D), pre + "attn.c_attn.bias": w(3 * D),
                   pre + "attn.c_proj.weight": w(D, D), pre + "attn.c_proj.bias": w(D),
                   pre + "ln_2.weight": torch.ones(D), pre + "ln_2.bias": w(D),
                   pre + "mlp.c_fc.weight": w(D, 4 * D), pre + "mlp.c_fc.bias": w(4 * D),
                   pre + "mlp.c_proj.weight": w(4 * D, D), pre + "mlp.c_proj.bias": w(D)})
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def hf_import_phase(card):
    """``lm_from_hf`` on the card without ``transformers``: a duck-typed
    model, a config namespace with GPT-2-small's published values and a
    seeded state dict in Hugging Face's names and layouts; the result is
    GPT-2 (learned positions, tied head, gelu, LayerNorm, biases) whose
    params are the state dict's tensors in the port's layout, served through
    ``ServingEngine(n_slots=8)`` on 8 of the ``serve`` mix's prompts, 32 new:
    finite tokens in range, exactly L K4 a decode step and 2L+1 K3-fwd a
    step and a prefill, nothing else. The parity with Hugging Face's own
    forward is the CPU test's."""
    from elephas_tpu_torch.models import lm_from_hf
    from elephas_tpu_torch.serving import ServingEngine

    cfg = types.SimpleNamespace(**GPT2_HF_CONFIG)
    sd = _gpt2_state_dict(cfg, SEED + 81)
    D, L = cfg.n_embd, cfg.n_layer
    c_attn = sd["transformer.h.3.attn.c_attn.weight"].numpy()
    wte = sd["transformer.wte.weight"].numpy().copy()
    t0 = time.perf_counter()
    model, params = lm_from_hf(types.SimpleNamespace(config=cfg, state_dict=lambda: sd),
                               device="cuda")
    convert_s = time.perf_counter() - t0
    require(model.tie_embeddings and model.pos_encoding == "learned"
            and model.activation == "gelu" and model.norm == "layernorm"
            and model.attn_bias and model.ffn_bias and model.n_layers == L,
            f"hf_import: architecture {vars(cfg)}")
    require(np.array_equal(params["wk"][3], c_attn[:, D:2 * D])
            and np.array_equal(params["tok"], wte), "hf_import: params moved")
    t0 = time.perf_counter()
    tparams = {k: torch.from_numpy(v).to("cuda") for k, v in params.items()}
    torch.cuda.synchronize()
    to_card_s = time.perf_counter() - t0
    gen = np.random.default_rng(SEED + 2)
    V = cfg.vocab_size
    prompts = [gen.integers(0, V, size=int(n)).astype(np.int32)
               for n in gen.integers(32, 257, size=16)][:8]
    eng = ServingEngine(model, tparams, n_slots=8, device="cuda")
    torch.cuda.synchronize()
    _zero_counters()
    fin, wall = _drain(eng, prompts, 32)
    counts = _read_counters()
    snap = eng.snapshot()
    steps, prefills = snap["engine"]["decode_steps"], snap["engine"]["prefills"]
    _want_counts("hf_import", counts, {"flash_decode_lse": L * steps,
                                       "layer_norm_fwd": (2 * L + 1) * (steps + prefills)})
    for f in fin:
        require(f.finish_reason == "length" and all(0 <= t < V for t in f.tokens),
                f"hf_import: {f.finish_reason}, tokens {f.tokens[:4]}")
    emit({"phase": "hf_import", "model": "GPT-2-small config (published widths), "
          f"seeded weights (seed {SEED + 81})", "convert_s": convert_s,
          "params_to_card_s": to_card_s, "requests": len(prompts), "new_tokens_each": 32,
          "decode_steps": steps, "prefills": prefills, "launches": counts,
          **_serving_stats(snap, fin, wall), "card": card})
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU and has nothing to run here",
              file=sys.stderr)
        return 2
    try:
        from elephas_tpu_torch import resolve_device
        from elephas_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    resolve_device("cuda")          # also pins float32 matmuls to full precision
    raw, name, limit = card_line()
    print(raw, flush=True)
    card = {"name": name, "power_limit": limit}
    emit({"phase": "card", **card, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    built = _build.build(["layer_norm", "flash_decode", "flash_attention",
                          "paged_attention", "grouped_matmul", "fused_xent"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": built, "card": card})
    try:
        ln_fwd = _walled("layer_norm_shapes", check_layer_norm, card)
        ln_bwd = _walled("layer_norm_bwd_shapes", check_layer_norm_bwd, card)
        decode = _walled("flash_decode_shapes", check_flash_decode, card)
        attn_rows = _walled("flash_attention_shapes", check_flash_attention, card)
        rope_rows = _walled("flash_attention_rope_shapes", check_flash_attention_rope, card)
        params, prompts, gpu_tokens, serve_counts, serve_stats = _walled("serve", serve,
                                                                         card)
        _walled("cross_check", cross_check, card, params, prompts, gpu_tokens)
        _walled("profile_decode", profile_decode, card, params, prompts)
        train_counts = _walled("train", train, card, params)
        _walled("train_cross_check", train_cross_check, card, params)
        gen_counts = _walled("generate", generate_phase, card, params)
        paged_rows = _walled("paged_attention_shapes", check_paged_attention, card)
        paged_tokens, paged_counts, paged_stats = _walled(
            "serve_paged", serve_paged, card, params, prompts, gpu_tokens, serve_stats)
        _walled("profile_paged", profile_paged, card, params, prompts)
        _walled("prefix", prefix, card, params)
        _walled("preempt", preempt, card, params)
        _walled("paged_cross_check", paged_cross_check, card, params, prompts, paged_tokens)
        spec_shapes = _walled("spec_verify_shapes", check_spec_kernels, card)
        spec_counts = _walled("serve_spec", serve_spec, card, params, prompts, gpu_tokens,
                              serve_stats)
        _walled("serve_spec_sampled", serve_spec_sampled, card, params, prompts)
        spec_paged_counts = _walled("serve_spec_paged", serve_spec_paged, card, params,
                                    prompts, paged_tokens, paged_stats)
        gen_spec_counts = _walled("generate_spec", generate_spec, card, params)
        _walled("spec_cross_check", spec_cross_check, card, params, prompts)
        gmm_rows = _walled("grouped_matmul_shapes", check_grouped_matmul, card)
        moe_model, moe_params, moe_prompts, moe_tokens, moe_counts, moe_stats = \
            _walled("serve_moe", serve_moe, card)
        moe_paged_counts = _walled("serve_moe_paged", serve_moe_paged, card, moe_model,
                                   moe_params, moe_prompts, moe_tokens, moe_stats)
        _walled("moe_cross_check", moe_cross_check, card, moe_params, moe_prompts)
        del moe_model, moe_params
        torch.cuda.empty_cache()
        _, moe_train_params, moe_train_counts = _walled("train_moe", train_moe, card)
        _walled("train_moe_cross_check", train_moe_cross_check, card, moe_train_params)
        del moe_train_params
        torch.cuda.empty_cache()
        xent_rows = _walled("fused_xent_shapes", check_fused_xent, card)
        mlp_counts = _walled("fit_mlp", fit_mlp, card)
        _walled("fit_matrix", fit_matrix, card)
        _walled("fit_cross_check", fit_cross_check, card)
        host_counts = _walled("fit_host", fit_host, card)
        _walled("fit_host_matrix", fit_host_matrix, card)
        _walled("fit_host_cross_check", fit_host_cross_check, card)
        _walled("checkpoint", checkpoint_phase, card)
        torch.cuda.empty_cache()
        llama_params, llama_counts, llama_summary = _walled("train_llama", train_llama,
                                                            card)
        _walled("train_llama_cross_check", train_llama_cross_check, card, llama_params)
        del llama_params
        torch.cuda.empty_cache()
        mt, mt_params, mt_prompts, mt_tokens, mt_counts, mt_stats = _walled(
            "serve_multi_tenant", serve_multi_tenant, card)
        mt_prefix_counts = _walled("multi_tenant_prefix", multi_tenant_prefix, card, mt,
                                   mt_params)
        mt_spec_counts = _walled("serve_multi_tenant_spec", serve_multi_tenant_spec, card,
                                 mt, mt_params, mt_prompts, mt_tokens, mt_stats)
        del mt, mt_params
        torch.cuda.empty_cache()
        lora_params, lora_counts = _walled("train_lora", train_lora, card, llama_summary)
        _walled("lora_cross_check", lora_cross_check, card, lora_params)
        del lora_params
        torch.cuda.empty_cache()
        window_rows = _walled("window_shapes", check_window_kernels, card)
        mistral_params, gen_window_counts = _walled("generate_window", generate_window,
                                                    card)
        train_window_counts = _walled("train_window", train_window, card, mistral_params)
        serve_window_counts, serve_window_paged_counts = _walled(
            "serve_window", serve_window, card, mistral_params)
        del mistral_params
        torch.cuda.empty_cache()
        beam_counts = _walled("beam", beam_phase, card, params)
        _walled("train_phases", train_phases, card, params)
        _walled("train_options", train_options, card)
        torch.cuda.empty_cache()
        cnn_counts, cnn_host_counts = _walled("fit_cnn", fit_cnn, card)
        bn_counts = _walled("fit_bn", fit_bn, card)
        _walled("fit_lstm", fit_lstm, card)
        _walled("fit_layers_cross_check", fit_layers_cross_check, card)
        torch.cuda.empty_cache()
        resnet_counts, resnet_k1, resnet_runs = _walled("fit_resnet", fit_resnet, card)
        _walled("fit_resnet_cross_check", fit_resnet_cross_check, card)
        _walled("fit_recurrent", fit_recurrent, card)
        options_counts = _walled("fit_options", fit_options, card)
        torch.cuda.empty_cache()
        xent16_rows = _walled("fused_xent_fp16_shapes", check_fused_xent_fp16, card)
        mixed_resnet_counts, mixed_mlp_counts = _walled("fit_mixed", fit_mixed, card,
                                                        resnet_runs)
        _walled("fit_mixed_cross_check", fit_mixed_cross_check, card)
        losses_counts = _walled("fit_losses_metrics", fit_losses_metrics, card)
        torch.cuda.empty_cache()
        transfer_counts = _walled("fit_transfer", fit_transfer, card, resnet_runs)
        _walled("fit_transfer_cross_check", fit_transfer_cross_check, card)
        graph_counts = _walled("fit_graph_options", fit_graph_options, card)
        torch.cuda.empty_cache()
        ml_counts, ml_est, ml_tr, ml_xt = _walled("ml_mlp", ml_mlp, card)
        _walled("ml_pipeline_lstm", ml_pipeline_lstm, card)
        _walled("ml_persist", ml_persist, card, ml_est, ml_tr, ml_xt)
        hyper_counts = _walled("hyperparam", hyperparam, card)
        fleet_model, fleet_trace, fleet_base, fleet_chaos, fleet_counts = _walled(
            "fleet", fleet, card, params)
        fleet_pbase, fleet_pchaos, fleet_paged_counts = _walled(
            "fleet_paged", fleet_paged, card, fleet_model, params, fleet_trace)
        _walled("fleet_cross_check", fleet_cross_check, card, fleet_model, params,
                fleet_trace, {"dense": (fleet_base, fleet_chaos),
                              "paged": (fleet_pbase, fleet_pchaos)})
        del fleet_base, fleet_chaos, fleet_pbase, fleet_pchaos
        torch.cuda.empty_cache()
        stream_counts = _walled("stream", stream, card)
        torch.cuda.empty_cache()
        resilience_counts = _walled("resilience_fit", resilience_fit, card)
        _walled("soak", soak, card)
        autoscaler_counts = _walled("fleet_autoscaler", fleet_autoscaler, card, fleet_model,
                                    params)
        supervised_counts = _walled("stream_supervised", stream_supervised, card)
        round_counts = _walled("round_options_fit", round_options_fit, card)
        torch.cuda.empty_cache()
        elastic_counts = _walled("fit_elastic", fit_elastic, card)
        _walled("native_loader", native_loader_phase, card)
        quant_counts = _walled("serve_quantized", serve_quantized, card)
        hf_counts = _walled("hf_import", hf_import_phase, card)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # each row's `launches` is its own slice's main path: dense serving for
    # K3-fwd and K4, the five timed train steps for K2 and K3-bwd, paged
    # serving for K5, MoE serving for K6-gmm, the three timed MoE train
    # steps for gmm_t and K6-tgmm, the MLP fit for K1 (its host path's
    # launches, from the worker threads, under launches_by_path), the three
    # timed Llama-3-8B-width train steps for the rope-on-load K2; K1's
    # launches in the CNN fits (the asynchronous compiled run, the host
    # run's threads, the BatchNormalization CNN's synchronous run) and in the
    # API skins (the estimator's fit, the search's trials from its worker
    # threads) are under launches_by_path, as are the speculative paths'
    # (serve_spec and serve_spec_paged: the sums of their drafters' runs;
    # generate_spec: of its four runs) and the LoRA paths' (the
    # multi-tenant serving runs' K5, the per-adapter drafter's K4, the LoRA
    # train step's rope K2); K5-chunk and K3-fwd carry their times at the
    # verify's shapes under verify_shapes; the fleet's chaos runs (dense:
    # K3-fwd and K4; paged: K5), fit_stream's train_fn (K2 and K3-bwd) and
    # the resilience fits (K1, from the worker threads on the host paths)
    # are under launches_by_path, as are the autoscaled fleet's (K3-fwd, K4),
    # the supervised fit_stream's train_fn (K2, K3-bwd), the round-option
    # host fits' (K1), the elastic hosts' (K1, counted in the host processes
    # over the committed contributions), quantized serving's (K4, K5, K6-gmm)
    # and the imported GPT-2's (K3-fwd, K4); the ResNet-50 fit's K1 (one
    # worker, no remat) and the options CNN's are under launches_by_path, K1's
    # times at the ResNet fits' [16 W, 10] under resnet_fit_shapes; K1's
    # float16 rows are their own (their main path the mixed_float16 MLP fit,
    # their times at its [256, 10] and the other shapes under shapes), the
    # mixed_bfloat16 ResNet-50 fit's K1 (one worker) and the loss and metric
    # phase's host fit's are under launches_by_path, as are the transfer
    # recipe's two ResNet-50 stages' (fit_transfer_frozen, fit_transfer_finetune)
    # and the graph options' small models' (compiled and host fits)
    rows = [ln_fwd, ln_bwd, decode, *attn_rows, *paged_rows, *gmm_rows, *xent_rows,
            *rope_rows, *xent16_rows]
    paths = {"serve": serve_counts, "train_5_steps": train_counts,
             "generate": gen_counts, "serve_paged": paged_counts,
             "serve_moe": moe_counts, "serve_moe_paged": moe_paged_counts,
             "train_moe_3_steps": moe_train_counts, "fit_mlp": mlp_counts,
             "fit_host": host_counts, "fit_cnn": cnn_counts,
             "fit_cnn_host": cnn_host_counts, "fit_bn": bn_counts,
             "train_llama_3_steps": llama_counts, "ml_mlp": ml_counts,
             "hyperparam": hyper_counts, "serve_spec": spec_counts,
             "serve_spec_paged": spec_paged_counts, "generate_spec": gen_spec_counts,
             "generate_window": gen_window_counts, "train_window_2_steps": train_window_counts,
             "serve_window": serve_window_counts,
             "serve_window_paged": serve_window_paged_counts, "beam": beam_counts,
             "serve_multi_tenant": mt_counts, "multi_tenant_prefix": mt_prefix_counts,
             "serve_multi_tenant_spec": mt_spec_counts, "train_lora_3_steps": lora_counts,
             "fleet": fleet_counts, "fleet_paged": fleet_paged_counts,
             "stream_train_fn": stream_counts, **resilience_counts,
             "fleet_autoscaler": autoscaler_counts,
             "stream_supervised_train_fn": supervised_counts, **round_counts,
             "fit_elastic_hosts": elastic_counts, **quant_counts, "hf_import": hf_counts,
             "fit_resnet": resnet_counts, "fit_options": options_counts,
             "fit_mixed_resnet50_bf16": mixed_resnet_counts,
             "fit_mixed_mlp_fp16": mixed_mlp_counts, **losses_counts, **transfer_counts,
             **graph_counts}
    main_paths = {"layer_norm_fwd": "serve", "flash_decode_lse": "serve",
                  "paged_flash_decode_lse": "serve_paged",
                  "paged_flash_chunk": "serve_paged", "gmm": "serve_moe",
                  "gmm_train": "train_moe_3_steps",
                  "gmm_t": "train_moe_3_steps", "tgmm": "train_moe_3_steps",
                  "fused_xent_fwd": "fit_mlp", "fused_xent_bwd": "fit_mlp",
                  "fused_xent_fwd_fp16": "fit_mixed_mlp_fp16",
                  "fused_xent_bwd_fp16": "fit_mixed_mlp_fp16",
                  **{r: "train_llama_3_steps" for r in ROPE_ROWS}}
    for row in rows:
        name = row["name"]
        counter = row.get("counter", name)
        main_path = main_paths.get(name, "train_5_steps")
        row["main_path"] = main_path
        row["launches"] = paths[main_path][counter]
        row["launches_by_path"] = {k: v.get(counter, 0) for k, v in paths.items()}
        if name in spec_shapes:
            row["verify_shapes"] = spec_shapes[name]
        if name in window_rows:
            row["window_shapes"] = window_rows[name]
        if name in resnet_k1:
            row["resnet_fit_shapes"] = resnet_k1[name]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
