"""Chip smoke of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py
    python3 chip_smoke.py --only images,replicas   # build, then these
                                                   # (images, generate,
                                                   # replicas, processes,
                                                   # gateway, cli,
                                                   # parallel, http,
                                                   # serve_features,
                                                   # import, mesh,
                                                   # rev_decode)

Drives the port (``dalle_pytorch_tpu_torch``) and nothing of JAX, at the
full width of the repo's north DALLE configuration (``bench.py``
``build_cfg(tiny=False)``: dim 512, depth 12, 8 heads of 64, text 256 +
image 1024 tokens, VAE 256 px / 2048 codes) with seeded random weights:

1. build  — compile every CUDA kernel from ``csrc/`` with nvcc (sm_90a),
   one nvcc per source, all at once; print the ``-Xptxas -v`` lines
   (registers, shared memory, spills) of the tensor-core kernels (K1,
   K2a, K2b split, K3; narrow and wide), of K4's dh-64 bodies and of the
   wide bodies (d above 128), and the card's name and power limit;
2. kernel — paged-attention kernel K4 against its plain PyTorch version
   at the serving shapes (8 slots, 8 heads, dh 64, page 16, L 1280),
   ragged positions including 0, 1, 15, 16, 17 and 1279, random data in
   every page including the trash page: float32 (TF32 off) to 1e-5,
   bfloat16 pages to 1e-2, int8 pages to rtol 1e-5 / atol 1e-4 (the
   unnormalised acc relative to its summands' magnitude, m, l and
   acc / l directly); the pos-0 slot's (0, FILL, 0) exactly, through
   the split walk (one long slot across five blocks beside short ones);
   timed with CUDA events beside the byte bound; then, untimed, dh 48
   (the dh-64 body reading rows at stride 48) in bfloat16 and int8, and
   dh 160, 192 and 256 in bfloat16 and int8 on the wide split body (the
   narrow body compiled for dh 256, rows at stride dh below it), the
   profiler naming it for every case; dh 256 timed at 8 slots x 2 heads
   (the wide serving shape) and 8 heads, beside the bound, the plain
   version and the CUDA-core wide body it replaced (held first);
3. decode — one full-width float32 decode step through the kernel
   against the dense gather (``paged_view`` + ``_gather_read``): h_out
   to 1e-4, then 64 greedy steps with identical tokens;
4. engine — the bfloat16 serving engine end to end at ``SERVE_DEPTH``
   (2: the ``engine``, ``sparse_engine``, ``wide_engine``,
   ``rev_decode``, ``http`` and ``serve_features``' bfloat16 engines and
   ``import``'s model are cut from depth 12 to keep the smoke's time,
   their float32 step checks are not) on 6
   requests
   (prompt lengths 1, 17 and 256; top-k, top-p 0.9 and one greedy):
   every result ok with 1024 image tokens in [0, 2048) and a finite
   (256, 256, 3) image; K4 launched depth x decode steps times; every
   page back on the free list; a re-run request gives identical tokens;
   then the six requests run again (same tokens), and a torch.profiler
   window over a few steady chunks, beside an unprofiled window with the
   same slots live, says where a decode step's time goes (device time
   per step, K4's share, the device's idle share);
5. flash  — the flash kernels K1 (forward: out, m, l), K2a (dq) and K2b
   (dk, dv; split and fused mode) against their plain PyTorch versions
   at the north training shapes (b 8, h 8, n 1280, d 64, causal,
   scale 512 ** -0.5), in bfloat16 and float32 (TF32 off), with the
   all-True mask training uses and with a text-padding mask (fully padded
   query rows included): float32 to rtol/atol 2e-4, bfloat16 to 2e-2,
   the bfloat16 gradients dq, dk and dv to atol 0.05 x their RMS where
   that is tighter (``grad_atol``), l to rtol/atol 1e-4; each
   record gives each output's RMS and the least atol it needed, and
   names the kernel that ran for each call, from the kernels the
   profiler saw, which must be the one ``FA.kernel_body`` names
   (bfloat16 K1, K2a and K2b, split and fused, on the tensor cores up to
   d 128 and, on the wide tensor-core bodies, at d 192 and 256; the rest
   on CUDA cores). Then, untimed, d 16 and 48 at b 2, h 2, n 300
   (zero-padded to the kernels' 64 by the wrappers), and d 192 and 320
   (the wide bodies) with both masks; then the wide bodies timed at
   b 8, h 2, n 1280, d 256 (the north width as heads=2, dim_head=256).
   Each case is
   timed with CUDA events and torch.profiler beside the plain version,
   the bound, and ``F.scaled_dot_product_attention`` (its forward, and
   its backward alone) as the library yardstick at the all-True mask;
6. train  — the north config's training step (bfloat16 params, batch 8,
   ``loss_chunk`` 256, flash attention with the split kernel backward,
   dropout 0.1, Adam lr 1e-4): random 256 px images through the VAE
   encoder to ids, then ``make_train_step`` for 6 steps with finite
   losses, K1, K2a and K2b each launched depth x steps times; ms per
   step, tokens per second and a profiler window (device time per step,
   K1's and K2's shares, kernels per step, idle share). Then at depth 2,
   full width, float32, one step's loss and every parameter's gradient
   under 'pallas' and 'pallas_fused' against the plain blockwise 'xla'
   backward: loss to rtol 1e-5, each gradient to 1e-4 of its largest
   element (f32 sums in other orders, and the fused dq's atomics);
7. wide_train — the same step at the north width split as heads=2,
   dim_head=256 (``WIDE_TRAIN``), dropout 0: 6 steps with finite
   losses, K1, K2a and K2b each launched depth x steps = 72 times, the
   profile naming the kernels that ran (the wide tensor-core bodies of
   K1, K2a and K2b split, none of the CUDA-core ones); ms per step,
   tokens per second, device ms, each kernel's ms per step, the idle
   share and peak memory. Then a depth-2 copy in bfloat16: loss and
   every gradient with 'pallas' against the plain blockwise 'xla'
   backward, to 2e-2 (of each gradient's largest element);
8. fused_train — the ``train`` phase's step with the fused single-pass
   backward (``attn_bwd_impl='pallas_fused'``) and dropout 0, at the
   north width as it is (8 heads of 64) and split as heads=2,
   dim_head=256: 6 steps each with finite losses, K1 and fused K2b each
   launched depth x steps = 72 times and K2a never, the profile naming
   the fused tensor-core bodies; ms per step, tokens per second, device
   ms, each kernel's ms per step, the idle share and peak memory. Then a
   depth-2 copy in bfloat16 at each width: loss and every gradient with
   'pallas_fused' against 'xla', to 2e-2 (of each gradient's largest
   element);
9. sparse_kernels — the block-sparse kernel K3 (out, m, l) against its
   plain version at the north training shapes (b 8, h 8, n 1280, d 64,
   block 16, causal, scale 512 ** -0.5), bfloat16 (tensor cores) and
   float32 (CUDA cores), all-True and text-padding masks, with the flash
   tolerances, and untimed at d 16 and 48 (b 2, h 2, n 300) and at d
   192 and 320 (the wide bodies: bfloat16 at d 192 on the tensor cores),
   with the wide tensor-core body timed at b 8, h 2, n 1280, d 256, each
   call's kernel named by the profiler as ``BS.kernel_body`` names it;
   then ``causal=False`` at the CLIP encoders' shapes (b 8,
   h 8, d 64: n 256 with caption padding, n 64), bfloat16 timed. Timed
   cases stand beside the plain version, the bound and
   ``F.scaled_dot_product_attention`` with the layout as a boolean mask
   (CUDA events and device time). The static and the blockwise backward
   against autograd through ``sparse_attention_ref`` in float32, each
   gradient to 2e-4 of its largest element. K4's visible walk against
   its plain version and against the prefix walk over the same fully
   masked rows at the serving shapes (8 heads, dh 64, page 16, L 1280),
   positions 0, 1, 15, 16, 17, 63, 64, 65 and 1279, in float32, bfloat16
   and int8 pages, with K4's tolerances; timed beside its byte bound; and
   in bfloat16 and int8 at 2 heads of 256 on the wide split body's
   visible twin (named by the profiler), beside the CUDA-core wide body;
10. sparse_train — the block-sparse north config at full depth (BASELINE
   config 4: depth 64, ``sparse_attn=(True, False) * 32``,
   ``sparse_impl='pallas'``, dense layers on the flash kernels with the
   split backward; bfloat16, batch 8, ``loss_chunk`` 256, dropout 0, Adam
   lr 1e-4) for 6 steps: finite losses, K3, K1, K2a and K2b each launched
   32 x steps times; ms per step, tokens per second, peak memory, a
   profiler window (K3's and K1 + K2's shares) and the plain sparse
   backward's time. Then at depth 2, full width, float32: loss and every
   gradient with 'pallas' against 'ref', as the ``train`` phase holds
   them;
11. wide_sparse_train — the same step at the width split as heads=2,
   dim_head=256 (``WIDE_SPARSE``): 6 steps with finite, falling losses,
   K3 launched 32 x steps times and K1, K2a and K2b 32 x steps each, the
   profile naming exactly their wide tensor-core bodies, each at most 32
   launches a step (none of the CUDA-core wide bodies); ms per step,
   tokens per second, device ms, each kernel's ms per step, the idle
   share and peak memory. Then a depth-2 copy in bfloat16: loss and
   every gradient with K3 and the split kernel backward against the same
   model on the kernels' plain versions: loss to 2e-2, each gradient to
   1e-2 of its norm;
12. sparse_engine — the north width with the sparse pattern at depth 12:
   one float32 decode step with sparse reads through K4's visible walk
   against the trimmed-gather oracle (h_out to 1e-4), then 64 greedy
   steps with identical tokens, identical with sparse reads off too;
   then the bfloat16 engine with ``sparse_reads=True`` on the six
   requests of the ``engine`` phase: every result ok, K4's visible walk
   and its prefix walk each launched 6 x decode steps times, every page
   freed, and the ``engine`` phase's profile windows;
13. wide_engine — serving at the north width split as heads=2,
   dim_head=256 (``WIDE_SERVE``), depth 12: one bfloat16 decode step
   through K4's wide split body against the gather oracle with bf16 and
   int8 caches (h_out to 2e-2 of its norm); at ``SERVE_DEPTH`` the
   bfloat16 engine on the
   six requests of the ``engine`` phase with profile windows early and
   late inside the run (ms a step, tokens/s, device ms, K4 ms and us a
   launch, idle share): every result ok, K4 launched depth x decode
   steps times, the profiles naming only the wide split body, every page
   freed, a re-run request with the same tokens; then the sparse pattern
   at the same width with ``sparse_reads=True`` on three requests: each
   walk's launches, and the profiles naming the wide split body of both;
14. generate — one-shot generation (``generate_images``) at the north
   width. A float32 dense-cache decode step against the paged path's
   gather oracle on the same 17-token prompt (h_out to 1e-4, then 64
   greedy steps with identical tokens); the reference CLIP at its
   published defaults (dim 512, 6 + 6 layers of 8 heads, text 256, 256
   px in 32 px patches, ``sparse_impl='pallas'``: K3 with causal=False
   in every layer) against ``'ref'`` on the same captions and images,
   float32 to 1e-4 and bfloat16 to atol 1e-2, K3 launched 12 times a
   call; then, in bfloat16 at depth 2 (``GENERATE_DEPTH``, cut from 12
   for the smoke's time), 4 full 256-token prompts with
   guidance 3.0, and int8 weights (``quantize_for_decode``) with an int8 cache on
   17-token prompts with top-p 0.9: 1024 image ids each in [0, 2048),
   finite (256, 256, 3) images, finite CLIP rerank scores with K3
   launched 12 times, the same tokens from a re-run with the same key;
   wall seconds a call, ms a decode step, images a second, and a
   profiler window of 16 guided steps (device ms and kernels a step,
   the device's idle share). Its models are built through the package
   root's reference facades (``DiscreteVAE(**cfg)``, ``DALLE(dim=,
   vae=, depth=, ...)``, ``CLIP(**cfg)``), and the guided run's rerank
   is the facade's ``DALLE.generate_images(text, clip=clip)``.

The rest of training, each phase at full width on seeded random weights,
bfloat16 parameters, batch 8, Adam lr 1e-4, 6 steps of which the first
is a warm-up (``slice_train``): finite losses, each kernel's launches a
step checked, wall ms a step, tokens or images a second, peak memory
and a profile window (device ms a step, the idle share):

15. vae_train — BASELINE config 1 (``bench.py::bench_vae``: the
   DiscreteVAE at 256 px, 2,048 codes of 256, 3 layers, hidden 128),
   the training scripts' Huber + mse loss, an EMA at decay 0.999 after
   every step (float32, moving); no attention kernel; the Gumbel noise's
   ms a step;
16. rev_train — BASELINE config 3 (``build_cfg(depth=12,
   reversible=True)``, flash with the split backward, ``loss_chunk``
   256): K1 24 launches a step (the backward recomputes each layer's
   attention), K2a and K2b 12; peak memory beside 2 steps of the same
   config with ``reversible=False``; at depth 2 with dropout 0.1, the
   loss and every gradient with the kernels against their plain versions
   (``kernels_vs_plain``: in float32 to 1e-4 of each gradient's norm; in
   bfloat16 each gradient's distance from a float32 copy at most twice
   the plain bf16 path's, or 1e-2 of its norm);
17. rev_decode — the same config decoding: one float32 step through K4
   against the gather oracle (h_out to 1e-4) and 64 greedy steps with
   identical tokens (the two-stream loop), then the bfloat16 engine on
   one 17-token request to its 1,024 image tokens, K4 launched depth x
   decode steps times, every page freed;
18. moe_train — ``bench.py::bench_moe`` (depth 12, every FF a top-2 MoE
   of 8 experts): K1, K2a and K2b 12 a step; the load-balance loss
   finite and positive, the loss equal to the CE plus ``moe_aux_coef``
   times it;
19. clip_train — ``CLIPConfig()``'s defaults with ``sparse_impl='pallas'``
   and padded captions: K3 (``causal=False``) 12 launches a step; at 2 +
   2 layers the kernels against their plain versions, as ``rev_train``;
20. remat — the ``train`` phase's config at dropout 0 for 2 steps under
   each of 'none', 'save_ln', 'dots' and 'full': the first loss
   identical, the second within 1e-3, peak memory per mode, K1 12, 12,
   24 and 24 launches a step; at depth 2, each mode's gradients against
   'none''s with the kernels, to 1e-2 of each norm.

The entry points a user calls, through ``main(argv)``:

21. cli — 16 PNGs at 256 px written by the port's encoder and read back
   equal (decode ms an image, and of a file using every row filter);
   ``train_vae`` one epoch of 2 steps at batch 8 on the north VAE (256
   px, 2,048 codes of 512, 3 layers, hidden 64) under
   ``--guard_transfers``; ``train_dalle`` at the
   north width (``CLI_DALLE``: flash with the split kernel backward,
   bfloat16, ``loss_chunk`` 256, dropout 0.1, an EMA at 0.999) for 2
   epochs of 2 steps, K1, K2a and K2b each launched 12 times a step, ms
   a step from its own metrics beside the ``train`` phase's; the same
   run in two legs (epoch 0, then ``--auto_resume``), each under
   ``--guard_transfers``, whose checkpoint payloads (parameters, Adam
   state, EMA) equal the uninterrupted run's byte for byte; a guarded
   depth-2 run with a ``.item()`` seeded into its step body raising
   ``RuntimeError`` at it, the sync debug mode restored; ``train_clip``
   (``CLI_CLIP``, its sparse 'ref' layers) for 2 steps under
   ``--guard_transfers``, each step body under the "error" mode; the
   checkpoint's bytes, the msgpack codec's read and
   write rates; ``gen_dalle`` of 2 images from the epoch-1 checkpoint,
   its grid PNG 260 x 518 x 3; each CLI's wall seconds and peak memory.
   Its data and VAE stay for ``parallel``'s CLI run;
21b. parallel — training across ranks at the north width, depth 4
   (``PARALLEL_DEPTH``, cut from 12 for the phase's time), bfloat16,
   ``train_cfg``'s flash kernels (split backward) and dropout 0.1,
   batch 8 global (``id_batch``): this process computes the one-process
   step (loss and every gradient) of each run from the seeded weights
   and key: dp, tp, fsdp and ep (the whole batch; ep's model a top-2
   MoE of 4 experts), sp (sp 1: the masks are drawn per global
   position), pp (``sequential_pp_loss``: 2 stages of 2 layers, 4
   microbatches, keys per stage); K1, K2a, K2b and K3 at a tp rank's 4
   heads against their plain versions (timed, with their bounds and
   SDPA); then two spawned rank processes over
   gloo on the one card (each its own CUDA context) check the
   collectives' values on CUDA tensors (gloo runs all-reduce,
   broadcast, all-gather, reduce-scatter and all-to-all on them;
   ppermute is staged through pinned host memory), and hold each run
   (dp 2, sp 2 ring, sp 2 Ulysses, pp 2, pp 2 with the pattern
   ``(True, False) x 2``: K3; tp 2, tp 2 sparse, fsdp 2, ep 2 under
   ``dalle_param_specs(mesh=)`` / ``dalle_moe_param_specs``, their
   gradients gathered whole) against the one-process step: bf16 loss to
   2e-2 relative and each gradient to 2e-2 of its largest entry (the
   image's axial position embeddings', ``BF16_SCATTERED``, to relative
   L2 2e-2), and a depth-2
   float32 copy to 1e-5 on the loss and 1e-4 of each gradient's largest
   entry; then 2 steps of each (the first a warm-up) with each rank's
   K1/K2a/K2b/K3 launches (dp, tp, fsdp, ep: depth x steps, tp at 4
   heads a rank; tp sparse half K3; pp: depth/2 x 4 x steps, the sparse
   run half K3; sp: none, as in JAX), ms a step beside the
   one process's, host ms and bytes a step inside ``collectives.py``,
   peak and parameter GiB, each rank's parameter bytes against the
   replicated model's and the reckoned share (``reckoned_bytes``); then
   generate_dp: 4 candidates over dp 2 (float32, depth 2) through
   ``generate_images(clip=, mesh=)``, each rank sampling and scoring its
   rows (K3 non-causal, launched as often as in this process's call),
   the images and the CLIP rerank's scores to 1e-4 of this process's
   ``generate_images(clip=)``, the same order, then the image ids of a
   ``return_img_seq`` call identical;
   then ``train_dalle --sp 2`` as two processes
   (``--coordinator``/``--num_processes``/``--process_id``) for one
   epoch over ``cli``'s PNGs and VAE (``CLI_DALLE`` at depth 4): rank 0 writes the
   checkpoint once, rank 1 nothing, and this process resumes it; beside
   it a one-rank NCCL group (the dp comparison, each NCCL collective)
   and two NCCL ranks on the one card (NCCL refuses: recorded).

The single engine's serving features and reference weights:

22. serve_features — 8 requests (prompts of 1, 17 and 256 tokens, two
   pairs sharing a prompt, two guided at cfg_scale 3.0, priorities 0 and
   1, top-k, top-p 0.9 and greedy) at the north width in bfloat16
   (depth ``SERVE_DEPTH``, cut from 12 for the smoke's time) on 8
   slots, K = 8, page 16, through three engines: A,
   the paged kernel
   engine with the prefix cache on a pool cut to four sequences
   (``FEATURE_PAGES``), so eviction fires, and the postprocess worker
   scoring every image through a seeded ``CLIPConfig()`` CLIP (K3
   non-causal); B, the same with ``speculative=4``,
   ``draft_layers=1``, each request capped at 256 image tokens (K4 once
   per draft and verify offset: rounds x (1 x 6 + 2 x 4)
   launches, and K4 held against its plain version at a verify offset's
   row mask on the run's live state); C, ``kv='dense'`` through the
   gather (no K4), capped as B. The checks: evicted >= 1, prefix_hits >= 2,
   cfg_pairs == 2, no page leaks, the index's clear() returning every
   page, K4's launch counts, the worker's scores against ``clip_apply``,
   an injected failure as ``status='error'``; then A, B and C in float32
   (depth 2, a 1-layer draft) must give identical tokens on six of the
   requests capped at 256 image tokens, eviction firing on a pool of
   ``IDENTITY_PAGES`` (in bfloat16 the share
   of identical tokens and the first divergences are printed). ms a step
   or round, image tokens/s, acceptance, the prefill ms warm admission
   saves, the pool's peak, the pages a guided pair holds over an
   unguided request's, evictions and a profiled window's idle share;
23. import — a seeded reference-layout DALLE ``state_dict`` at the north
   width through ``import_torch dalle``, ``gen_dalle`` (one image on the
   card) and ``import_torch export-dalle``: every tensor back bit for
   bit; the seconds of each.

The HTTP server:

24. http — the port's ``InferenceServer`` behind ``make_http_server`` at
   the north width (bfloat16, depth ``SERVE_DEPTH``; 8 slots, K = 8,
   page 16, the
   kernel read, the prefix cache, a preview every 32 chunks,
   ``serve_features``' CLIP): six concurrent clients with one 17-token
   prompt and seed (plain; a stream; ``n_samples=2``;
   ``image_seq_len_override=256``; a stream torn after 3 token events;
   ``cfg_scale=3.0``), one wave of the 8 slots; a mid-decode
   ``/admin/profile`` capture naming K4's body; the error answers (400,
   404, 401, 409); the streamed tokens A's, the group's sample 0 A's, the
   short grid A's prefix, the torn stream reaped, K4 and K3's launches,
   pages, ``/metrics``, ``/healthz``; e2e and queue-wait percentiles, the
   first streamed token's seconds, ms a step and image tokens a second
   under the server.

Image files and the fleet:

25. images — the committed JPEG fixture (``tests/fixtures/images/``,
   40 x 48, 4:2:0) through ``data/images.py``'s libjpeg loader
   (``native/``, built with g++ here) against PIL's decode stored beside
   it, bit for bit, and the 256 px fixture against the SHA-256 of PIL's
   decode, its decode ms an image; where the machine has no libjpeg,
   the typed ``UnsupportedImage`` naming it instead (the record says
   which happened); then the lossless WebP fixture (40 x 56 RGBA)
   through libwebp (``ctypes``) against PIL's decode stored beside it,
   bit for bit, or the typed refusal naming libwebp;
25b. mesh — the serving mesh (``serve/mesh_engine.py``) at the north
   width and ``SERVE_DEPTH`` over two entries of ``cuda:0`` (one card:
   ``serve_specs.visible_devices`` substituted): float32 tokens of 4
   requests (prompts of 208, 239 and 256 tokens) capped at 256 image
   tokens equal the single engine's,
   dense, paged (the gather) and paged int8, and again over ``cuda:0``
   and the CPU (two distinct devices) at 32 image tokens; the paged
   pool's bytes a shard equal the reckoning from its shapes, half the
   pool's; a mesh built from a host copy adds the model to the card
   once; the bytes a decode step joins, reckoned here and at depth 12;
   the kernel read refused typed; ``InferenceServer(mesh_devices=2)`` with
   CLIP answering 2 requests, ``/healthz`` naming the mesh, K3 12 an
   image; a thread ``ReplicaSet`` of two mesh slices replaying a crash
   of slice 1 with the single engine's tokens; bfloat16 ms a decode
   step, mesh against single (recorded); whether a product over half
   the heads gives the whole product's bits, on the card and the CPU;
26. replicas — A: a ``ReplicaSet`` of 2 thread replicas stepped from one
   thread (``step_once``), float32 at depth 2 and the north width (4
   slots each, K = 8,
   page 16, the kernel read), 256-token prompts capped at 128 image
   tokens: a wave of 8 through a crash of replica 1 at its 2nd chunk,
   a wave of 4 through a drain of replica 0 with live migration (then
   undrained), a wave of 4 through a rolling upgrade to a second seeded
   model (``v2``, one canary a replica), and a wave of 2 on ``v2``.
   Every request's tokens equal a single engine's of its version (4
   slots, the replicas' shapes); failovers, reclaimed requests and
   migrations equal ``REPLICA_EXPECT``, which the same schedule gives on
   the CPU (``tests/test_torch_replica.py``); K4 launched in both
   replicas; the set's, the engines', the queue's, the handles' and
   K4's locks watched by the lock-order sanitizer (``LockWatch``): no
   inversion, and every order seen (``lock_edges``) one that the port's
   racelint predicts over its package. B: ``InferenceServer`` over HTTP
   in bfloat16 at ``SERVE_DEPTH``, 256-token prompts capped at 256
   image tokens: six clients in one wave against a set of 1 replica
   and then of 2 (4 slots each: image tokens a second and ms a step of
   each), then a wave during which ``POST /admin/scale`` adds a replica
   and removes replica 0 with a drain; every result ok, K4 launched;
27. processes — replicas as child processes (``isolation='process'``),
   each with its own CUDA context; K4's library built here before the
   first child spawns, the children only load it. A: ``replicas`` A's
   shapes and stepping over 2 children, f32 at depth 2, on the socket
   transport (dial-back to 127.0.0.1 with a token): a wave of 8 through
   a real SIGKILL of child 1 at its 2nd chunk, then 4 through a garbage
   frame and 4 through the RSS watchdog (exit 137; limit the READY RSS +
   4 GiB) of its replacements, each spawned under the next plan; 4
   through a rolling upgrade (one canary a replica), 2 on the new
   version, 4 through a drain of child 0 that live-migrates between
   processes; every request's f32 tokens a single engine's, three
   failovers with their deaths decoded, ``completed`` and
   ``tokens_decoded`` exactly every request once, K4 in every child (its
   launches through its frames); each child's bring-up (READY's
   stamps), failover s (fence -> replacement READY) and migration s. B:
   ``replicas`` B's server, prompts and grid over 2 children (pipes) in
   bf16 at depth 2 with CLIP scoring in the parent (K3): an untimed
   warm-up wave on both children, six clients with both children, then
   six with child 1 drained; image tokens a second, each child's ms a
   step (its own clock over its steps, from its frames) and K4
   launches, the ratio of 2 over 1 and of the pair over ``replicas``
   B's thread pair of the same call;
28. gateway — ``serve/gateway.py``'s ``Gateway`` over cells of 4 slots
   (paged, page 16, the kernel read, the prefix cache) at
   ``SERVE_DEPTH``. A, float32, thread cells: 2 prompts x 5 waves in
   rotated order through a fresh 2-cell fleet with prefix affinity and
   one without (affinity's fleet prefix-hit rate strictly higher); on
   the affinity fleet 8 requests (256-token prompts capped at 128 image
   tokens), 2 as a ``gold`` tenant with ``hedge_s`` 0 (hedges >= 1) and
   8 through ``gateway_cell_down_at_request`` (the busiest cell killed
   with two requests mid-stream: one cell down, replays, no loss, the
   seconds from the death to the last replayed result), every token a
   lone 4-slot engine's. B, bfloat16, the HTTP surface over 2 process
   cells (each server spawns 2 children, one removed: the server takes
   process isolation only from 2 replicas), CLIP in each cell's parent:
   a ``victim`` tenant (weight 2) and an ``abuser`` (weight 1, rps 2) on
   one cell; an untimed warm-up, 6 victim requests alone and 6 under the
   ``tenant_flood`` row (24 abuser submits over HTTP: typed 429s with
   ``Retry-After``, every admitted request ok, the victim's p95 within
   1.5 x alone + 0.25 s); ``/metrics``' fleet samples the cells' stats;
   ``/admin/tenants`` 401 without the token, 200 with; image tokens a
   second of 8 clients over both cells and over one (the other closed),
   each child's ms a step from its frames, the gateway's added latency
   (submit -> dispatch) p50 and p99 over the victim's requests; K4 in
   every cell, K3 12 an image.

The default run takes the phases in two streams to stay well inside its
time limit. This process builds, checks and times the kernels (phases
1-3, 5, ``sparse_kernels`` and the tp shapes of ``parallel``) and runs
the training phases alone. Then a second process (``--stream``) runs the
phases in ``STREAM`` (``cli``, ``parallel``, ``replicas``,
``processes``, ``import``, ``mesh``, ``rev_decode``) while this one runs
the other serving phases. Both streams share the card, so the wall times and ms a step of
the phases after that point are taken beside the other stream; the
kernel rows are not. ``--only`` runs the phases it names one after
another in this process, for numbers taken alone.

Each phase prints one JSON line; the kernel table and the card line
follow, and the last line is ``{"ok": true, "device": {...}}``. Any
failed check raises, so the script exits non-zero and prints no result.
It needs a CUDA card: without one it exits 2 before doing anything.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS = 67e12               # H100 SXM, float32 outside tensor cores
BF16_FLOPS = 989e12              # H100 SXM, bf16 tensor cores, dense


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


PHASE_SECONDS: dict = {}


def timed(phase, *args):
    """Run ``phase(*args)`` and keep its wall seconds under its name."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[phase.__name__] = time.perf_counter() - t0
    return out


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(prof) -> dict:
    """{kernel name: (device us, launches)} from a torch.profiler run."""
    kernels = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        old_us, old_n = kernels.get(e.key, (0.0, 0))
        kernels[e.key] = (old_us + float(us), old_n + e.count)
    return kernels


def top_kernels(kernels: dict, steps: int, n: int = 8,
                width: int = 90) -> dict:
    """The ``n`` kernels with the most device time, ms per step, names
    cut to ``width`` characters (kernels whose cut names coincide are
    summed, not overwritten)."""
    out = {}
    for k, (us, _) in kernels.items():
        out[k[:width]] = out.get(k[:width], 0.0) + us / 1e3 / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:n])


KERNEL_CLASSES = (("flash", ("flash_fwd", "flash_bwd")),
                  ("block_sparse", ("block_sparse_fwd",)),
                  ("paged_decode", ("paged_decode",)),
                  ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
                  ("elementwise", ("elementwise",)),
                  ("reduce", ("reduce",)))


def kernel_classes(kernels: dict, steps: int) -> dict:
    """Device ms per step by kind of kernel, by name: the port's own
    kernels, matrix products, elementwise passes, reductions, the rest."""
    out = {name: 0.0 for name, _ in KERNEL_CLASSES}
    out["other"] = 0.0
    for k, (us, _) in kernels.items():
        kind = next((name for name, keys in KERNEL_CLASSES
                     if any(key in k for key in keys)), "other")
        out[kind] += us / 1e3 / steps
    return out


# depth of the serving phases' engines (``engine``, ``sparse_engine``,
# ``wide_engine``, ``rev_decode``, ``http`` and ``serve_features``'
# bfloat16 engines; their float32 step and identity checks keep their
# depths) and of ``import``'s model, cut from 12 to keep the smoke's
# time; their steps are host-bound, a fixed cost plus a share per layer
SERVE_DEPTH = 2


def north_cfg():
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    vcfg = V.VAEConfig(image_size=256, num_tokens=2048, codebook_dim=512,
                       num_layers=3, hidden_dim=64)
    return D.DALLEConfig(dim=512, depth=12, vae=vcfg, num_text_tokens=10000,
                         text_seq_len=256, heads=8, dim_head=64)


def ptxas_lines(log: str, part: str) -> dict:
    """{kernel: its ``-Xptxas -v`` lines (stack, spills; registers, shared
    memory)} for the kernels whose (mangled) name holds ``part``."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if part in line else None
        elif name and ("spill" in line or "Used" in line):
            out.setdefault(name, []).append(line.strip())
    return out


def phase_build() -> str:
    from dalle_pytorch_tpu_torch.ops import build
    t0 = time.perf_counter()
    libs = build.build_all()
    emit(phase="build", ok=True, seconds=time.perf_counter() - t0,
         libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()},
         wgmma_ptxas=ptxas_lines(build.build_log("flash_attention"),
                                 "wgmma"),
         block_sparse_ptxas=ptxas_lines(build.build_log("block_sparse"),
                                        "wgmma"),
         paged_ptxas=ptxas_lines(build.build_log("paged_attention"),
                                 "Li64E"),
         wide_ptxas={name: ptxas_lines(build.build_log(name), "wide")
                     for name in build.SOURCES})
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return out


def kernel_inputs(dtype, page_size=16, slots=8, heads=8, dh=64,
                  L=1280, seed=0, positions=(0, 1, 15, 16, 17, 1279, 640,
                                             1000)):
    """North serving shapes: the engine's fully provisioned pool (8 slots
    x 80 pages + trash), one distinct page run per slot, ragged pos."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mp = L // page_size
    P = slots * mp + 1
    dev = "cuda"
    pos = torch.tensor(positions[:slots], dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    bt = perm.reshape(slots, mp).to(torch.int32)
    need = (pos.long() + page_size - 1) // page_size
    cols = torch.arange(mp, device=dev)[None, :]
    bt = torch.where(cols < need[:, None], bt, 0)        # unmapped -> trash
    j = torch.arange(L, device=dev)
    allowed = j[None, :] < pos[:, None].long()
    allowed[5, 3] = False                                 # padded rows
    allowed[7, :5] = False
    q = torch.randn((slots, heads, dh), generator=g, device=dev)
    shape = (P, heads, page_size, dh)
    if dtype == torch.int8:
        kp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8)
        ksc = 0.01 + 0.09 * torch.rand(shape[:-1], generator=g, device=dev)
        vsc = 0.01 + 0.09 * torch.rand(shape[:-1], generator=g, device=dev)
        return (q.to(torch.bfloat16), kp, vp, bt, pos, allowed,
                {"k_scales": ksc, "v_scales": vsc})
    kp = torch.randn(shape, generator=g, device=dev).to(dtype)
    vp = torch.randn(shape, generator=g, device=dev).to(dtype)
    return q.to(dtype), kp, vp, bt, pos, allowed, {}


def walk_bound(q, kp, pages: int, list_bytes: int, scales) -> tuple:
    """Least ms of one K4 launch that walks ``pages`` pages in all: what
    the walk reads once each (K and V of the walked rows with their
    scales, by ``paged_attention.kv_row_bytes``; the allowed byte of each
    walked row; the block-table entry of each walked page; q; the
    per-slot walk lengths and lists, ``list_bytes``) and writes (acc, m,
    l) over HBM rate, against its float32 multiply-adds over the
    CUDA-core rate."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    b, heads, dh = q.shape
    rows = pages * kp.shape[2]
    kv = rows * heads * PA.kv_row_bytes(dh, kp.element_size(), bool(scales))
    io = (q.numel() * q.element_size() + rows + pages * 4 + list_bytes
          + b * heads * (dh + 2) * 4)
    t_bytes = (kv + io) / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * rows * heads * dh / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(q, kp, pos, scales) -> tuple:
    """``walk_bound`` of the prefix walk: ``ceil(pos / page_size)`` pages
    a slot, its length read from ``pos``."""
    ps = kp.shape[2]
    pages = int(((pos.long() + ps - 1) // ps).sum())
    return walk_bound(q, kp, pages, pos.numel() * 4, scales)


# the __global__ of a profiler's kernel name (namespace and template
# arguments cut): K4's (as PA.kernel_body names them) and K3's
K4_NAME = r"(paged_decode\w*?_kernel)<"
K3_NAME = r"(block_sparse_\w+?_kernel)<"


def launched_bodies(fn, pattern: str, calls: int = 12,
                    attempts: int = 4) -> list:
    """The ``__global__`` functions (``pattern``'s group) that ``calls``
    profiled calls of ``fn`` ran. A session that records none (one may
    drop the records of its first milliseconds, and 12 calls of a short
    kernel last less than one) is tried again with four times the calls,
    up to ``attempts``; then []."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls * 4 ** attempt):
                fn()
            torch.cuda.synchronize()
        names = sorted({f for k in device_kernels(prof)
                        for f in re.findall(pattern, k)})
        if names:
            return names
    return []


@contextlib.contextmanager
def k4_cuda_core_route():
    """K4's bfloat16 and int8 calls above dh 128 sent back to the
    CUDA-core wide body, at its own split size: the "before" of the wide
    split body, timed in the same run."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    wide_split = PA.wide_split
    PA.wide_split = lambda kv_dtype, dh: False
    try:
        yield
    finally:
        PA.wide_split = wide_split


def named_device_us(fn, name: str, iters: int = 20, warm: int = 4,
                    attempts: int = 3):
    """Device time per launch of the kernels whose name holds ``name``,
    from torch.profiler sessions opened with ``warm`` launches (see
    ``flash_device_us``); "not measured" if no session records one."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warm + iters):
                fn()
            torch.cuda.synchronize()
        hits = [(us, n) for k, (us, n) in device_kernels(prof).items()
                if name in k]
        n = sum(c for _, c in hits)
        if n:
            return sum(us for us, _ in hits) / n
    return "not measured"


def partials_held(what: str, got, want, mag, rtol, atol) -> float:
    """K4's (acc, m, l) against the plain version's; returns the max abs
    error. The unnormalised acc sums up to 1279 signed terms in another
    order, so its error scales with the summands' magnitude
    ``mag`` = sum_j p_j |v_j|, not with the (cancelling) sum itself: acc
    is held to rtol of that magnitude; m, l and the normalised output
    acc / l to rtol/atol directly."""
    err = float((got[0] - want[0]).abs().max())
    check(bool(((got[0] - want[0]).abs() <= rtol * mag + atol).all()),
          f"{what}: acc differs from the plain version (max abs "
          f"{err:.3e})")
    live = want[2] > 0
    out_k = got[0][live] / got[2][live][:, None]
    out_p = want[0][live] / want[2][live][:, None]
    for a, b, name in ((got[1], want[1], "m"), (got[2], want[2], "l"),
                       (out_k, out_p, "acc / l")):
        check(torch.allclose(a, b, rtol=rtol, atol=atol),
              f"{what}: {name} differs from the plain version (max abs "
              f"{float((a - b).abs().max()):.3e})")
        err = max(err, float((a - b).abs().max()))
    return err


def phase_kernel() -> dict:
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    scale = 512 ** -0.5
    cases = {"float32": (torch.float32, 1e-5, 1e-5),
             "bfloat16": (torch.bfloat16, 1e-2, 1e-2),
             "int8": (torch.int8, 1e-5, 1e-4)}
    results = {}
    for name, (dtype, rtol, atol) in cases.items():
        q, kp, vp, bt, pos, allowed, sc = kernel_inputs(dtype)
        kw = dict(scale=scale, **sc)
        got = PA.paged_decode_attention(q, kp, vp, bt, pos, allowed, **kw)
        want = PA.paged_decode_attention_plain(q, kp, vp, bt, pos, allowed,
                                               **kw)
        mag = PA.paged_decode_attention_plain(q, kp, vp.abs(), bt, pos,
                                              allowed, **kw)[0]
        torch.cuda.synchronize()
        err = partials_held(f"K4 {name}", got, want, mag, rtol, atol)
        check(float(got[1][0, 0]) == PA.FILL and float(got[2][0].abs().max())
              == 0.0 and float(got[0][0].abs().max()) == 0.0,
              f"K4 {name}: the pos-0 slot must return (0, FILL, 0)")
        ms = cuda_ms(lambda: PA.paged_decode_attention(
            q, kp, vp, bt, pos, allowed, **kw), iters=200)
        device_us = named_device_us(lambda: PA.paged_decode_attention(
            q, kp, vp, bt, pos, allowed, **kw), "paged_decode_kernel",
            iters=50)
        plain = cuda_ms(lambda: PA.paged_decode_attention_plain(
            q, kp, vp, bt, pos, allowed, **kw), iters=50)
        bms, by = bound_ms(q, kp, pos, sc)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                         "bound_ms": bms, "bound_by": by,
                         "us_per_launch": ms * 1e3,
                         "device_us_per_launch": device_us,
                         "plain_us": plain * 1e3, "bound_us": bms * 1e3}
        emit(phase="kernel", case=name, ok=True, rtol=rtol, atol=atol,
             **results[name])
    # a head dim between the compiled widths: the dh-64 body, rows read
    # at stride 48, lanes past 48 zero
    for name in ("bfloat16", "int8"):
        dtype, rtol, atol = cases[name]
        q, kp, vp, bt, pos, allowed, sc = kernel_inputs(dtype, dh=48)
        kw = dict(scale=scale, **sc)
        got = PA.paged_decode_attention(q, kp, vp, bt, pos, allowed, **kw)
        want = PA.paged_decode_attention_plain(q, kp, vp, bt, pos, allowed,
                                               **kw)
        mag = PA.paged_decode_attention_plain(q, kp, vp.abs(), bt, pos,
                                              allowed, **kw)[0]
        torch.cuda.synchronize()
        check(got[0].shape == (8, 8, 48), f"K4 {name} dh 48: acc shape "
                                          f"{tuple(got[0].shape)}")
        err = partials_held(f"K4 {name} dh 48", got, want, mag, rtol, atol)
        results[f"{name}/dh48"] = {"max_abs_err": err}
        emit(phase="kernel", case=f"{name}/dh48", ok=True, rtol=rtol,
             atol=atol, max_abs_err=err)
    # heads above 128: bfloat16 and int8 pages on the wide split body
    # (dh 160 and 192 at stride dh), its prefix walk split into runs of
    # WIDE_SPLIT_ROWS rows; timed at dh 256 with 2 heads (the wide serving
    # shape, heads=2, dim_head=256) and 8 (8 slots x 8 heads), beside the
    # CUDA-core wide body it replaces
    for dh, heads in ((160, 8), (192, 8), (256, 8), (256, 2)):
        for name in ("bfloat16", "int8"):
            dtype, rtol, atol = cases[name]
            key = f"{name}/dh{dh}" + ("" if heads == 8 else f"/h{heads}")
            rec = wide_case(key, dtype, rtol, atol, dh, heads,
                            timed=dh == 256)
            results[key] = rec
            emit(phase="kernel", case=key, ok=True, rtol=rtol, atol=atol,
                 **rec)
    return results


def wide_case(key, dtype, rtol, atol, dh: int, heads: int,
              timed: bool) -> dict:
    """K4's prefix walk at 128 < dh <= 256 on the serving shapes of
    ``kernel_inputs``, against its plain version with K4's tolerances,
    the pos-0 slot's (0, FILL, 0) exactly, the kernel the profiler saw
    the one ``PA.kernel_body`` names (the wide split body); timed: CUDA
    events and profiler device us a launch beside the bound and the
    plain version, and the CUDA-core wide body's the same way, held
    first to the same tolerances."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    q, kp, vp, bt, pos, allowed, sc = kernel_inputs(dtype, heads=heads,
                                                    dh=dh)
    kw = dict(scale=512 ** -0.5, **sc)
    call = lambda: PA.paged_decode_attention(   # noqa: E731
        q, kp, vp, bt, pos, allowed, **kw)
    plain = lambda: PA.paged_decode_attention_plain(   # noqa: E731
        q, kp, vp, bt, pos, allowed, **kw)
    got, want = call(), plain()
    mag = PA.paged_decode_attention_plain(q, kp, vp.abs(), bt, pos, allowed,
                                          **kw)[0]
    torch.cuda.synchronize()
    check(got[0].shape == (8, heads, dh), f"K4 {key}: acc shape "
                                          f"{tuple(got[0].shape)}")
    err = partials_held(f"K4 {key}", got, want, mag, rtol, atol)
    check(float(got[1][0, 0]) == PA.FILL and float(got[2][0].abs().max())
          == 0.0 and float(got[0][0].abs().max()) == 0.0,
          f"K4 {key}: the pos-0 slot must return (0, FILL, 0)")
    body = PA.kernel_body(kp.dtype, dh)
    ran = launched_bodies(call, K4_NAME)
    check(ran == [body] and PA.wide_split(kp.dtype, dh),
          f"K4 {key}: ran {ran}, not [{body}]")
    rec = {"max_abs_err": err, "body": body}
    if not timed:
        return rec
    bms, by = bound_ms(q, kp, pos, sc)
    ms = cuda_ms(call, iters=200)
    rec.update(ms=ms, us_per_launch=ms * 1e3,
               device_us_per_launch=named_device_us(call, body + "<",
                                                    iters=50),
               plain_ms=cuda_ms(plain, iters=20), bound_ms=bms, bound_by=by,
               bound_us=bms * 1e3)
    rec["plain_us"] = rec["plain_ms"] * 1e3
    with k4_cuda_core_route():
        old = "paged_decode_wide_kernel"
        ran = launched_bodies(call, K4_NAME)
        check(ran == [old], f"K4 {key}: the CUDA-core route ran {ran}")
        rec["cuda_core_max_abs_err"] = partials_held(
            f"K4 {key} CUDA-core body", call(), want, mag, rtol, atol)
        rec["cuda_core_us_per_launch"] = cuda_ms(call, iters=100) * 1e3
        rec["cuda_core_device_us_per_launch"] = named_device_us(
            call, old + "<", iters=50)
    return rec


def phase_decode() -> None:
    emit(phase="decode", ok=True, **paged_decode_check(north_cfg()))


def paged_decode_check(cfg) -> dict:
    """One float32 decode step of ``cfg`` at 8 ragged slots through K4
    against the gather oracle (h_out to 1e-4), then 64 greedy steps with
    identical tokens, each path writing its own pool."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    tcfg = cfg.transformer
    model = D.dalle_init(cfg, seed=1, dtype=torch.float32)
    slots, ps, L = 8, 16, cfg.seq_len
    mp = L // ps
    P = slots * mp + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    shape = (tcfg.depth, P, tcfg.heads, ps, tcfg.dim_head)
    pool = {"k": torch.randn(shape, generator=g, device="cuda"),
            "v": torch.randn(shape, generator=g, device="cuda")}
    oracle = {k: v.clone() for k, v in pool.items()}
    bt = (torch.arange(P - 1, device="cuda") + 1).reshape(slots, mp) \
        .to(torch.int32)
    pos = torch.tensor([0, 1, 15, 16, 17, 300, 640, 1000],
                       dtype=torch.int32, device="cuda")
    key_mask = torch.ones((slots, L), dtype=torch.bool, device="cuda")
    active = torch.ones((slots,), dtype=torch.bool, device="cuda")
    tok = torch.randint(0, cfg.num_text_tokens, (slots,), generator=g,
                        device="cuda").to(torch.int32)
    kw = dict(cfg=tcfg, key_mask=key_mask, active=active)
    worst = 0.0
    with torch.no_grad():
        for step in range(64):
            x = D.decode_token_embed(model, tok, pos)
            h_k = decode_ops.decode_step_paged(model.transformer, x, pos,
                                               pool, bt, **kw)
            h_g = decode_ops.decode_step_paged(model.transformer, x, pos,
                                               oracle, bt,
                                               attn_impl="gather", **kw)
            if step == 0:
                check(torch.allclose(h_k, h_g, rtol=1e-4, atol=1e-4),
                      f"decode step: kernel h_out differs from the gather "
                      f"oracle (max abs "
                      f"{float((h_k - h_g).abs().max()):.3e})")
            worst = max(worst, float((h_k - h_g).abs().max()))
            forbid = D.logits_mask(cfg, pos)
            t_k = D.to_logits(model, h_k).masked_fill(forbid, -math.inf) \
                .argmax(-1)
            t_g = D.to_logits(model, h_g).masked_fill(forbid, -math.inf) \
                .argmax(-1)
            check(torch.equal(t_k, t_g),
                  f"decode step {step}: greedy tokens differ")
            tok = torch.where(pos + 1 >= cfg.text_seq_len,
                              t_k - cfg.num_text_tokens, t_k) \
                .to(torch.int32)
            pos = pos + 1
    return {"steps": 64, "slots": slots, "max_abs_h_diff": worst}


def profile_window(engine, chunks: int) -> dict:
    """``chunks`` chunks timed without the profiler, then the next
    ``chunks`` under torch.profiler, with the same slots live in both.
    Gives device kernel time per step (all kernels, and K4's share), the
    wall per step of each window, and the device's idle share against
    the unprofiled wall (the profiler's own host cost inflates the
    profiled wall, so the idle share inside that window is only an upper
    bound). Device time the profiler cannot see is reported as not
    measured."""
    from torch.profiler import ProfilerActivity, profile
    live = engine.active_slots()
    first_step = engine.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        engine.step_once()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(chunks):
            engine.step_once()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    check(engine.active_slots() == live, "a slot finished inside a "
          "profiled window")
    steps = chunks * engine.chunk_steps
    kernels = device_kernels(prof)
    total_us = sum(us for us, _ in kernels.values())
    out = {"steps": steps, "live_slots": live, "first_step": first_step,
           "wall_ms_per_step": plain_wall_ms / steps,
           "wall_ms_per_step_profiled": wall_ms / steps}
    if total_us <= 0:
        out["device_ms_per_step"] = "not measured"
        return out
    k4 = [(us, n) for k, (us, n) in kernels.items() if "paged_decode" in k]
    k4_us = sum(us for us, _ in k4)
    vis = [(us, n) for k, (us, n) in kernels.items()
           if "paged_decode_visible" in k]
    vis_us = sum(us for us, _ in vis)
    device_ms = total_us / 1e3 / steps
    out.update(device_ms_per_step=device_ms,
               k4_bodies=sorted({f for k in kernels
                                 for f in re.findall(K4_NAME, k)}),
               k4_ms_per_step=k4_us / 1e3 / steps,
               k4_us_per_launch=k4_us / max(1, sum(n for _, n in k4)),
               k4_share_of_device=k4_us / total_us,
               k4_visible_ms_per_step=vis_us / 1e3 / steps,
               k4_visible_share_of_device=vis_us / total_us,
               k4_prefix_share_of_device=(k4_us - vis_us) / total_us,
               device_idle_share=max(0.0, 1 - device_ms
                                     / out["wall_ms_per_step"]),
               device_idle_share_profiled=max(0.0, 1 - total_us / 1e3
                                              / wall_ms),
               kernels_launched_per_step=sum(
                   n for _, n in kernels.values()) / steps,
               top_kernels_ms_per_step=top_kernels(kernels, steps),
               kinds_ms_per_step=kernel_classes(kernels, steps))
    return out


def profile_decode(engine, queue, reqs, want_tokens, chunks: int = 4,
                   late_chunk: int = 110) -> dict:
    """Where a steady decode step's time goes, with the main run's
    requests in flight: they are submitted again and admitted by one
    step, and a ``profile_window`` is taken early (after two steady
    chunks) and late (from chunk ``late_chunk``, every slot still live
    at a long position), since K4's work grows with the positions. The
    re-run must give every request's tokens again."""
    handles = [queue.submit(r) for r in reqs]
    prof = profile_run(engine, chunks, late_chunk)
    for h, want in zip(handles, want_tokens):
        res = h.result(timeout=0)
        check(res.ok and list(res.tokens) == list(want),
              f"re-run request {res.request_id} gave other tokens")
    return prof


def profile_run(engine, chunks: int = 4, late_chunk: int = 110) -> dict:
    """The engine's submitted requests run to their end, admitted by the
    first step, with a ``profile_window`` early (after two steady
    chunks) and late (from chunk ``late_chunk``)."""
    base = engine.decode_steps          # a slot's pos is its prompt length
    for _ in range(3):                  # plus the steps since admission
        engine.step_once()
    early = profile_window(engine, chunks)
    for _ in range(late_chunk - 3 - 2 * chunks):
        engine.step_once()
    late = profile_window(engine, chunks)
    for w in (early, late):
        w["first_step"] -= base
    engine.run_until_idle()
    return {"early": early, "late": late}


def engine_requests(cfg) -> list:
    """Six requests: prompt lengths 1, 17 and 256, top-k, top-p 0.9 and
    one greedy."""
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    g = torch.Generator().manual_seed(5)

    def prompt(n):
        return tuple(int(t) for t in torch.randint(
            1, cfg.num_text_tokens, (n,), generator=g))

    top_p = S.SamplingParams(top_p=0.9)
    greedy = S.SamplingParams(filter_thres=1.0)
    return [S.Request(prompt(1), seed=10), S.Request(prompt(17), seed=11),
            S.Request(prompt(256), seed=12),
            S.Request(prompt(1), seed=13, sampling=top_p),
            S.Request(prompt(17), seed=14, sampling=greedy),
            S.Request(prompt(256), seed=15, sampling=top_p)]


def check_engine_results(cfg, reqs, results) -> None:
    """Every result ok, with image_seq_len tokens in [0, image vocab), a
    finite (256, 256, 3) image and its prompt at the head of the text."""
    for r, res in zip(reqs, results):
        check(res.ok, f"request {res.request_id}: {res.status} "
                      f"{res.reason}")
        toks = torch.as_tensor(res.tokens)
        check(toks.shape == (cfg.image_seq_len,)
              and int(toks.min()) >= 0
              and int(toks.max()) < cfg.num_image_tokens,
              f"request {res.request_id}: bad image tokens")
        img = torch.as_tensor(res.image)
        check(img.shape == (256, 256, 3) and bool(torch.isfinite(img).all()),
              f"request {res.request_id}: bad image {tuple(img.shape)}")
        check(list(res.text_tokens[:len(r.codes)]) == list(r.codes),
              f"request {res.request_id}: text span lost its prompt")


def phase_engine() -> dict:
    import dataclasses
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    cfg = dataclasses.replace(north_cfg(), depth=SERVE_DEPTH)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    reqs = engine_requests(cfg)
    post = PostProcessor(vae, model)
    queue = S.RequestQueue(max_prompt_len=cfg.text_seq_len)
    engine = Engine(model, queue, num_slots=8, chunk_steps=8, kv="paged",
                    page_size=16, paged_attn="kernel", complete=post)
    check(engine.num_pages == 1 + 8 * 80, "pool must be 1 + 8*80 pages")
    handles = [queue.submit(r) for r in reqs]
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.paged_decode_attention.launches
    results = [h.result(timeout=0) for h in handles]
    check_engine_results(cfg, reqs, results)
    check(launches == cfg.depth * engine.decode_steps,
          f"K4 launched {launches} times, expected depth x decode steps = "
          f"{cfg.depth * engine.decode_steps}")
    check(engine.alloc.in_use == 0, f"{engine.alloc.in_use} pages leaked")
    stats = engine.stats()
    # tokens_decoded counts every sampled position, text span included;
    # users receive the image tokens
    image_tokens = len(reqs) * cfg.image_seq_len

    # replay: the same request alone gives the same tokens
    again = queue.submit(reqs[2])
    engine.run_until_idle()
    check(again.result(timeout=0).ok and list(again.result().tokens)
          == list(results[2].tokens), "re-run request gave other tokens")
    check(engine.alloc.in_use == 0, "pages leaked after the re-run")
    prof = profile_decode(engine, queue, reqs,
                          [res.tokens for res in results])
    check(engine.alloc.in_use == 0, "pages leaked after the profiled run")

    # prefill: the 256 bucket's two-row group, as admission runs it
    text = torch.randint(1, cfg.num_text_tokens, (2, 256), device="cuda")
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: decode_ops.prefill(
            model.transformer, D.embed_prompt(model, text),
            cfg=cfg.transformer), iters=10, warmup=2)
        vae_ms = cuda_ms(lambda: post.decode(results[0].tokens), iters=10,
                         warmup=2)
    record = dict(phase="engine", ok=True, requests=len(reqs),
                  wall_s=wall, decode_steps=stats["decode_steps"],
                  ms_per_decode_step=wall * 1e3 / stats["decode_steps"],
                  tokens_per_s=stats["tokens_decoded"] / wall,
                  tokens_decoded=stats["tokens_decoded"],
                  image_tokens_per_s=image_tokens / wall,
                  image_tokens=image_tokens,
                  harvests=stats["harvests"],
                  prefill_runs=stats["prefill_runs"],
                  pages_peak=stats["pages_peak"],
                  prefill_ms_bucket256_2rows=prefill_ms,
                  vae_ms_per_image=vae_ms, k4_launches=launches,
                  profile=prof)
    emit(**record)
    return record


# -- flash attention: K1, K2a, K2b --------------------------------------------

FLASH_SCALE = 512 ** -0.5        # the north config's dim ** -0.5
# heads above 128 (the wide bodies): the untimed head dims, and the timed
# shape: the north width split as heads=2, dim_head=256 (bench.py
# build_cfg takes heads * dim_head = 512), batch 8, causal
WIDE_DIMS = (192, 320)
WIDE_TIMED = dict(b=8, h=2, n=1280, d=256)


def flash_tolerances(dtype) -> tuple:
    """(rtol, atol) of the kernels' outputs against the plain versions:
    float32 2e-4 (both accumulate in f32, over 1,280 terms in another
    order; the fused dq adds its shares with atomics in an order that
    changes from run to run); bfloat16 2e-2 (one bf16 rounding of the
    output, 2^-8 relative, on either side). The bfloat16 gradients take
    a tighter atol: ``grad_atol``."""
    return (2e-4, 2e-4) if dtype == torch.float32 else (2e-2, 2e-2)


# a bfloat16 gradient's atol as a share of its own RMS. At the north
# shapes a typical |dq| (and |dk|) is 0.35 / sqrt(row), under 0.02 past
# row 300, so the 2e-2 floor alone passes a key tile left out of the
# late rows' sums (chip_flash_variants.py's planted fault); what is left
# of the error past rtol x |want| is a few bf16 roundings of single
# terms, 0.4 % of the RMS at most at the north shapes
BF16_GRAD_ATOL_OF_RMS = 0.05


def rms(t) -> float:
    return float(t.float().square().mean().sqrt())


def grad_atol(dtype, want, atol) -> float:
    """The atol a gradient ``want`` is held to: bfloat16's ``atol``
    tightened to ``BF16_GRAD_ATOL_OF_RMS`` x RMS(want); float32's as it
    is."""
    if dtype != torch.bfloat16:
        return atol
    return min(atol, BF16_GRAD_ATOL_OF_RMS * rms(want))


def atol_needed(got, want, rtol) -> float:
    """The least atol at which ``got`` holds against ``want`` at rtol."""
    excess = ((got.float() - want.float()).abs()
              - rtol * want.float().abs()).max()
    return max(float(excess), 0.0)


def flash_inputs(dtype, masked: bool, b=8, h=8, n=1280, d=64, seed=0):
    """North training shapes. ``masked``: text padding as DALLE batches
    carry it (text lengths 1..256 of the 256 text positions; image
    positions always kept), so padded text rows are fully padded query
    rows; otherwise the all-True mask ``train_dalle`` builds."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, n, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    mask = torch.ones((b, n), dtype=torch.bool, device="cuda")
    if masked:
        for i, t in enumerate((1, 17, 64, 100, 200, 255, 256, 30)[:b]):
            mask[i, t:256] = False
    return q, k, v, do, mask


def flash_bound(kind: str, dtype, b, h, n, d) -> tuple:
    """(least ms, 'bytes' | 'operations') of one causal call: the tile
    products over the causal pairs only (what this data needs) at the
    peak rate of the inputs' type, against each input read once and each
    output written once at the HBM rate."""
    pairs = n * (n + 1) // 2 * b * h
    products = {"fwd": 2, "dq": 3, "dkv": 4, "fused": 5}[kind]
    flops = 2 * d * pairs * products
    elems = b * h * n * d
    isz = torch.tensor([], dtype=dtype).element_size()
    rows = b * h * n * 4                       # one f32 per row
    nbytes = {"fwd": 4 * elems * isz + 2 * rows,
              "dq": 5 * elems * isz + 3 * rows,
              "dkv": 6 * elems * isz + 3 * rows,
              "fused": 6 * elems * isz + 3 * rows + 4 * elems}[kind]
    nbytes += b * n                            # the mask
    rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# which device kernels each flash call may launch, as (name part,
# template part); ``FA.kernel_body`` names the one each call runs
FLASH_KERNELS = {"fwd": (("flash_fwd_wgmma_kernel", ""),
                         ("flash_fwd_kernel", ""),
                         ("flash_fwd_wide_wgmma_kernel", ""),
                         ("flash_fwd_wide_kernel", "")),
                 "dq": (("flash_bwd_dq_wgmma_kernel", ""),
                        ("flash_bwd_dq_kernel", ""),
                        ("flash_bwd_dq_wide_wgmma_kernel", ""),
                        ("flash_bwd_dq_wide_kernel", "")),
                 "dkv": (("flash_bwd_dkv_wgmma_kernel", ""),
                         ("flash_bwd_dkv_kernel", "false>"),
                         ("flash_bwd_dkv_wide_wgmma_kernel", ""),
                         ("flash_bwd_dkv_wide_kernel", "false>")),
                 "fused": (("flash_bwd_fused_wgmma_kernel", ""),
                           ("flash_bwd_dkv_kernel", "true>"),
                           ("flash_bwd_fused_wide_wgmma_kernel", ""),
                           ("flash_bwd_dkv_wide_kernel", "true>"))}


def is_flash_kernel(kind: str, name: str) -> bool:
    return any(part in name and variant in name
               for part, variant in FLASH_KERNELS[kind])


def flash_body(names) -> list:
    """The ``__global__`` functions of the profiler's kernel names
    ``names`` (namespace and template arguments cut), as
    ``FA.kernel_body`` names them; [] when none was recorded."""
    return sorted({fn for k in names
                   for fn in re.findall(r"(flash_\w+?_kernel)<", k)})


def flash_bodies(kernels: dict) -> dict:
    """{K1 'fwd', K2a 'dq', K2b split 'dkv', K2b fused 'fused': the flash
    functions a profile ``kernels`` recorded for it}."""
    return {kind: flash_body(k for k in kernels if is_flash_kernel(kind, k))
            for kind in ("fwd", "dq", "dkv", "fused")}


def flash_device_us(calls: dict, iters: int = 8, warm: int = 4,
                    attempts: int = 3) -> tuple:
    """Each flash kernel's device time per launch from torch.profiler,
    averaged over the launches a session recorded, and the names of the
    kernels recorded for each call. A profiler session now and then
    comes back without the records of its first few milliseconds, so
    each session opens with ``warm`` launches of every call before
    ``iters`` more of each, and the calls still unmeasured are profiled
    again, up to ``attempts`` sessions; what is still missing is
    reported as not measured."""
    from torch.profiler import ProfilerActivity, profile
    out = {kind: "not measured" for kind in calls}
    names = {kind: [] for kind in calls}
    for _ in range(attempts):
        todo = [kind for kind, us in out.items() if isinstance(us, str)]
        if not todo:
            break
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warm):
                for kind in todo:
                    calls[kind][0]()
            for kind in todo:
                for _ in range(iters):
                    calls[kind][0]()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        for kind in todo:
            hits = [(k, us, n) for k, (us, n) in kernels.items()
                    if is_flash_kernel(kind, k)]
            n = sum(c for _, _, c in hits)
            if n:
                out[kind] = sum(us for _, us, _ in hits) / n
                names[kind] = [k for k, _, _ in hits]
    return out, names


def all_device_us(fn, iters: int = 10, warm: int = 3,
                  attempts: int = 3) -> float:
    """Device time of every kernel ``fn`` launches, per call, from
    torch.profiler: the session's total over the launch count of the
    call's longest kernel (one a call), so records a session drops at
    its start drop from both. A session that records nothing is tried
    again, up to ``attempts``; then "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(warm + iters):
                fn()
            torch.cuda.synchronize()
        kernels = device_kernels(prof)
        if kernels:
            _, calls = max(kernels.values())
            return sum(us for us, _ in kernels.values()) / calls
    return "not measured"


def held(what: str, got, want, rtol, atol) -> float:
    """Checks got against want elementwise; returns the max abs error."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    worst = float(err.max())
    check(ok, f"{what} differs from its plain version (max abs "
              f"{worst:.3e}, rtol {rtol}, atol {atol})")
    return worst


def case_name(dtype, masked: bool, d: int) -> str:
    name = f"{str(dtype).split('.')[-1]}/{'pad' if masked else 'all_true'}"
    return name if d == 64 else f"{name}/d{d}"


def flash_case(dtype, masked: bool, timed: bool, **shape) -> dict:
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    q, k, v, do, mask = flash_inputs(dtype, masked, **shape)
    b, h, n, d = q.shape
    name = case_name(dtype, masked, d)
    rtol, atol = flash_tolerances(dtype)
    kw = dict(scale=FLASH_SCALE, causal=True, mask=mask)
    out, m, l = FA.flash_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = FA.flash_attention_fwd_plain(q, k, v, **kw)
    errs = {"fwd": held(f"K1 {name} out", out, out_p, rtol, atol)}
    errs["fwd_m"] = held(f"K1 {name} m", m, m_p, rtol, atol)
    errs["fwd_l"] = held(f"K1 {name} l", l, l_p, 1e-4, 1e-4)
    dstat = (do.float() * out_p.float()).sum(-1)
    args = (q, k, v, do, m_p, l_p, dstat)
    dq_p = FA.flash_attention_bwd_dq_plain(*args, **kw)
    dk_p, dv_p, dq32_p = FA.flash_attention_bwd_dkv_plain(*args, with_dq=True,
                                                          **kw)
    gatol = {"dq": grad_atol(dtype, dq_p, atol),
             "dk": grad_atol(dtype, dk_p, atol),
             "dv": grad_atol(dtype, dv_p, atol)}
    dq = FA.flash_attention_bwd_dq(*args, **kw)
    errs["dq"] = held(f"K2a {name} dq", dq, dq_p, rtol, gatol["dq"])
    dk, dv, _ = FA.flash_attention_bwd_dkv(*args, **kw)
    errs["dkv"] = max(
        held(f"K2b split {name} dk", dk, dk_p, rtol, gatol["dk"]),
        held(f"K2b split {name} dv", dv, dv_p, rtol, gatol["dv"]))
    # how tight each output's atol is: its RMS, and the least atol at which
    # it holds at rtol
    wants = {"fwd": out_p, "dq": dq_p, "dk": dk_p, "dv": dv_p}
    gots = {"fwd": out, "dq": dq, "dk": dk, "dv": dv}
    tight = {kind: {"rms": rms(want),
                    "atol_needed": atol_needed(gots[kind], want, rtol)}
             for kind, want in wants.items()}
    dk, dv, dq32 = FA.flash_attention_bwd_dkv(*args, with_dq=True, **kw)
    errs["fused"] = max(
        held(f"K2b fused {name} dk", dk, dk_p, rtol, gatol["dk"]),
        held(f"K2b fused {name} dv", dv, dv_p, rtol, gatol["dv"]),
        held(f"K2b fused {name} dq", dq32, dq32_p, rtol, gatol["dq"]))
    torch.cuda.synchronize()
    del dq_p, dk_p, dv_p, dq32_p
    record = {"case": name, "rtol": rtol, "atol": atol, "grad_atol": gatol,
              "max_abs_err": errs, "tightness": tight}
    calls = {
        "fwd": (lambda: FA.flash_attention_fwd(q, k, v, **kw),
                lambda: FA.flash_attention_fwd_plain(q, k, v, **kw)),
        "dq": (lambda: FA.flash_attention_bwd_dq(*args, **kw),
               lambda: FA.flash_attention_bwd_dq_plain(*args, **kw)),
        "dkv": (lambda: FA.flash_attention_bwd_dkv(*args, **kw),
                lambda: FA.flash_attention_bwd_dkv_plain(*args, **kw)),
        "fused": (lambda: FA.flash_attention_bwd_dkv(*args, with_dq=True,
                                                     **kw),
                  lambda: FA.flash_attention_bwd_dkv_plain(
                      *args, with_dq=True, **kw)),
    }
    device_us, names = flash_device_us(calls, *((8, 4) if timed else (1, 1)))
    record["bodies"] = {kind: flash_body(k) for kind, k in names.items()}
    # every call runs the body the dispatch names: bfloat16 K1, K2a and
    # K2b (split and fused) on the tensor cores up to d 128, K1 and K2b at
    # d 192 and 256 (the wide tensor-core bodies); the rest on CUDA cores
    # ([]: the profiler recorded none of the call's launches)
    for kind in calls:
        want = FA.kernel_body(kind, dtype, d)
        check(record["bodies"][kind] in ([want], []),
              f"{name}: {kind} ran {record['bodies'][kind]}, not {want}")
    if not timed:
        return record
    for kind, (kernel, plain) in calls.items():
        bms, by = flash_bound(kind, dtype, b, h, n, d)
        record[kind] = {
            "ms": cuda_ms(kernel, iters=20, warmup=2),
            "device_us_per_launch": device_us[kind],
            "plain_ms": cuda_ms(plain, iters=3, warmup=1),
            "bound_ms": bms, "bound_by": by}
    # the library yardstick: one PyTorch call computing the same function
    # (causal, no padding) — timed here, used nowhere in the port. Its
    # backward is timed alone: one forward kept with its graph, then only
    # torch.autograd.grad, again and again
    import torch.nn.functional as F
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, is_causal=True, scale=FLASH_SCALE)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                       scale=FLASH_SCALE)
    sdpa_bwd = lambda: torch.autograd.grad(   # noqa: E731
        o, leaves, do, retain_graph=True)
    record["library"] = {
        "sdpa_fwd_ms": cuda_ms(sdpa, iters=20, warmup=2),
        "sdpa_fwd_device_us": all_device_us(sdpa),
        "sdpa_bwd_ms": cuda_ms(sdpa_bwd, iters=20, warmup=2),
        "sdpa_bwd_device_us": all_device_us(sdpa_bwd)}
    return record


def phase_flash() -> dict:
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for masked in (False, True):
            rec = flash_case(dtype, masked, timed=not masked)
            results[rec["case"]] = rec
            emit(phase="flash", ok=True, **rec)
    # head dims the wrappers pad to the kernels' 64, with text padding
    for d in (16, 48):
        for dtype in (torch.bfloat16, torch.float32):
            rec = flash_case(dtype, True, timed=False, b=2, h=2, n=300, d=d)
            results[rec["case"]] = rec
            emit(phase="flash", ok=True, **rec)
    # heads above 128: the wide bodies, untimed at d 192 and 320, then
    # timed at the north width split as heads=2, dim_head=256
    for d in WIDE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for masked in (False, True):
                rec = flash_case(dtype, masked, timed=False, b=2, h=2,
                                 n=300, d=d)
                results[rec["case"]] = rec
                emit(phase="flash", ok=True, **rec)
    rec = flash_case(torch.bfloat16, False, timed=True, **WIDE_TIMED)
    results[rec["case"]] = rec
    emit(phase="flash", ok=True, **rec)
    return results


# -- training -----------------------------------------------------------------

def train_cfg(**kw):
    import dataclasses
    base = dict(attn_impl="flash", attn_bwd_impl="pallas", attn_dropout=0.1,
                ff_dropout=0.1, loss_chunk=256)
    base.update(kw)
    return dataclasses.replace(north_cfg(), **base)


def train_batch(cfg, b=8, seed=9) -> dict:
    """Random text ids, the all-True text mask ``train_dalle`` builds, and
    random images in [-1, 1), made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    size = cfg.vae.image_size
    return {"text": torch.randint(1, cfg.num_text_tokens,
                                  (b, cfg.text_seq_len), generator=g,
                                  device="cuda"),
            "mask": torch.ones((b, cfg.text_seq_len), dtype=torch.bool,
                               device="cuda"),
            "image": torch.rand((b, size, size, 3), generator=g,
                                device="cuda") * 2 - 1}


def flash_counts(reset: bool = False) -> dict:
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    fns = {"k1": FA.flash_attention_fwd, "k2a": FA.flash_attention_bwd_dq,
           "k2b": FA.flash_attention_bwd_dkv}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {k: fn.launches for k, fn in fns.items()}


def train_profile(step, model, batch, key, steps: int = 2) -> dict:
    """``steps`` steps unprofiled, then ``steps`` under torch.profiler:
    device time per step (all kernels; K1's and K2's shares), kernels
    launched per step, the wall per step of each window, and the device's
    idle share against the unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(model, batch, key(100 + i))
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3 / steps
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(model, batch, key(200 + i))
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    kernels = device_kernels(prof)
    total_us = sum(us for us, _ in kernels.values())
    out = {"steps": steps, "wall_ms_per_step": plain_wall,
           "wall_ms_per_step_profiled": wall}
    if total_us <= 0:
        out["device_ms_per_step"] = "not measured"
        return out

    def share(kind):
        return sum(us for k, (us, _) in kernels.items()
                   if is_flash_kernel(kind, k))

    k1, k2a, k2b, fused = (share(k) for k in ("fwd", "dq", "dkv", "fused"))
    k3 = sum(us for k, (us, _) in kernels.items() if "block_sparse_fwd" in k)
    device_ms = total_us / 1e3 / steps
    out.update(device_ms_per_step=device_ms,
               k3_ms_per_step=k3 / 1e3 / steps,
               k3_share_of_device=k3 / total_us,
               k1_ms_per_step=k1 / 1e3 / steps,
               k2a_ms_per_step=k2a / 1e3 / steps,
               k2b_ms_per_step=k2b / 1e3 / steps,
               k2b_fused_ms_per_step=fused / 1e3 / steps,
               k1_share_of_device=k1 / total_us,
               k2_share_of_device=(k2a + k2b + fused) / total_us,
               kernels_launched_per_step=sum(
                   n for _, n in kernels.values()) / steps,
               device_idle_share=max(0.0, 1 - device_ms / plain_wall),
               device_idle_share_profiled=max(0.0, 1 - device_ms / wall),
               top_kernels_ms_per_step=top_kernels(kernels, steps, n=12),
               kinds_ms_per_step=kernel_classes(kernels, steps),
               flash_bodies=flash_bodies(kernels),
               body_launches_per_step=body_launches(kernels, steps))
    return out


def body_launches(kernels: dict, steps: int) -> dict:
    """{``__global__`` function of the port's flash and block-sparse
    kernels (as ``kernel_body`` names it): launches per step} of a
    profile ``kernels`` over ``steps`` steps."""
    out = {}
    for k, (_, n) in kernels.items():
        for fn in set(re.findall(r"((?:flash|block_sparse)_\w+?_kernel)<",
                                 k)):
            out[fn] = out.get(fn, 0) + n / steps
    return out


def train_grads_agree(batch, dtype=torch.float32,
                      impls=("pallas", "pallas_fused"), **cfg_kw) -> dict:
    """Depth 2, full width: one step's loss and every gradient under the
    kernel backwards ``impls`` against the plain blockwise one ('xla'),
    which shares the forward (K1). float32: loss to rtol 1e-5, each
    gradient to 1e-4 of its largest element (f32 sums in other orders,
    and the fused dq's atomics); bfloat16: both to 2e-2, the flash
    kernels' bf16 tolerance (each side rounds p, ds and every gradient
    to bf16 at its own places in the sums)."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    loss_rtol, grad_rtol = (1e-5, 1e-4) if dtype == torch.float32 else \
        (2e-2, 2e-2)
    enc = V.vae_encoder_init(north_cfg().vae, seed=7, dtype=dtype)
    key = prng.prng_key(5, device="cuda")
    got = {}
    for impl in ("xla",) + tuple(impls):
        model = D.dalle_init(train_cfg(depth=2, attn_bwd_impl=impl,
                                       **cfg_kw), seed=8, dtype=dtype)
        loss = dalle_loss_fn(enc)(model, batch, key)
        loss.backward()
        got[impl] = (float(loss.detach()), {n: p.grad.float() for n, p in
                                   model.named_parameters()})
        del model
    ref_loss, ref = got["xla"]
    worst = {}
    for impl in impls:
        loss, grads = got[impl]
        check(math.isfinite(loss) and abs(loss - ref_loss)
              <= loss_rtol * abs(ref_loss),
              f"train {impl}: loss {loss} against xla {ref_loss}")
        rel = 0.0
        for name, g in grads.items():
            scale_ = float(ref[name].abs().max())
            err = float((g - ref[name]).abs().max())
            check(err <= grad_rtol * max(scale_, 1e-30),
                  f"train {impl}: grad {name} differs from xla (max abs "
                  f"{err:.3e}, largest {scale_:.3e})")
            rel = max(rel, err / max(scale_, 1e-30))
        worst[impl] = {"loss": loss, "max_grad_err_of_largest": rel}
    worst["xla_loss"] = ref_loss
    worst["tolerance"] = {"loss_rtol": loss_rtol,
                          "grad_of_largest": grad_rtol}
    return worst


def train_run(cfg, phase: str, steps: int = 6, warmup: int = 1) -> tuple:
    """``steps`` training steps of ``cfg`` (bfloat16 params, the smoke's
    batch, Adam lr 1e-4 through ``make_train_step``), the first a
    warm-up: finite losses, K1 and K2b each launched depth x steps times,
    K2a as often under the split backward and never under the fused one
    (``attn_bwd_impl='pallas_fused'``, where K2b's count is of fused
    launches); then a profile window. Returns (record, batch, key)."""
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer, step_rng
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import (dalle_loss_fn,
                                                         make_train_step)
    enc = V.vae_encoder_init(cfg.vae, seed=7, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=6, dtype=torch.bfloat16)
    args = types.SimpleNamespace(lr=1e-4, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)
    step = make_train_step(dalle_loss_fn(enc),
                           make_optimizer(args, model.parameters()))
    batch = train_batch(cfg)
    root = prng.prng_key(0, device="cuda")

    def key(i):
        return step_rng(root, i)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_counts(reset=True)
    losses = [step(model, batch, key(i)) for i in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(model, batch, key(i)) for i in range(warmup, steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - warmup)
    counts = flash_counts()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"{phase} losses {losses}")
    fused = cfg.attn_bwd_impl == "pallas_fused"
    for k, n in counts.items():
        want = 0 if fused and k == "k2a" else cfg.depth * steps
        check(n == want, f"{phase}: {k} launched {n} times, expected "
                         f"{want} (depth {cfg.depth}, {steps} steps, "
                         f"{cfg.attn_bwd_impl})")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = batch["text"].shape[0] * cfg.seq_len
    prof = train_profile(step, model, batch, key)
    del model, step
    torch.cuda.empty_cache()
    record = dict(phase=phase, ok=True, steps=steps, losses=losses,
                  ms_per_step=ms, tokens_per_step=tokens,
                  tokens_per_s=tokens / ms * 1e3, peak_mem_gib=peak_gib,
                  launches=counts, profile=prof)
    return record, batch, key


def phase_train() -> dict:
    from dalle_pytorch_tpu_torch.ops import prng
    cfg = train_cfg()
    record, batch, key = train_run(cfg, "train")
    # one dropout keep-mask of each shape the step draws (attention output,
    # GEGLU hidden): threefry in int64, 2 x depth masks a step
    b, n = batch["text"].shape[0], cfg.seq_len
    mask_ms = {name: cuda_ms(lambda shape=shape: prng.bernoulli(
        key(0), 0.9, shape), iters=5, warmup=1)
        for name, shape in (("attn", (b, n, cfg.dim)),
                            ("ff", (b, n, cfg.dim * 4)))}
    mask_ms["per_step"] = cfg.depth * (mask_ms["attn"] + mask_ms["ff"])
    record.update(dropout_mask_ms=mask_ms, depth2_f32=train_grads_agree(batch))
    emit(**record)
    return record


# the north width split as heads=2, dim_head=256 (``bench.py::build_cfg``
# takes heads * dim_head = 512), dropout 0 (the JAX DALLEConfig default)
WIDE_TRAIN = dict(heads=2, dim_head=256, attn_dropout=0.0, ff_dropout=0.0)


def phase_wide_train() -> dict:
    """The ``train`` phase's step at ``WIDE_TRAIN``: K1, K2a and K2b split
    on the wide tensor-core bodies, each launched depth x steps times and
    named in the profile (none of the CUDA-core wide bodies); then a
    depth-2 copy in bfloat16, where those bodies run, against the plain
    blockwise backward."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    cfg = train_cfg(**WIDE_TRAIN)
    record, batch, _ = train_run(cfg, "wide_train")
    bodies = record["profile"].get("flash_bodies", {})
    for kind in ("fwd", "dq", "dkv"):
        want = [FA.kernel_body(kind, torch.bfloat16, cfg.dim_head)]
        check(bodies.get(kind) == want,
              f"wide_train: {kind} ran {bodies.get(kind)}, not {want}")
    record["depth2_bf16"] = train_grads_agree(batch, dtype=torch.bfloat16,
                                              impls=("pallas",),
                                              **WIDE_TRAIN)
    emit(**record)
    return record


# the fused single-pass backward at the north width and at WIDE_TRAIN's
# split, dropout 0 (the JAX DALLEConfig default) at both
FUSED_WIDTHS = {"north": dict(attn_dropout=0.0, ff_dropout=0.0),
                "wide": WIDE_TRAIN}


def phase_fused_train() -> dict:
    """The ``train`` phase's step under ``attn_bwd_impl='pallas_fused'``
    at both widths of ``FUSED_WIDTHS``: K1 and fused K2b on their
    tensor-core bodies, each launched depth x steps times and named in
    the profile, K2a never launched; then a depth-2 copy in bfloat16
    against the plain blockwise backward."""
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    records = {}
    for width, kw in FUSED_WIDTHS.items():
        cfg = train_cfg(attn_bwd_impl="pallas_fused", **kw)
        record, batch, _ = train_run(cfg, f"fused_train/{width}")
        bodies = record["profile"].get("flash_bodies", {})
        for kind in ("fwd", "fused"):
            want = [FA.kernel_body(kind, torch.bfloat16, cfg.dim_head)]
            check(bodies.get(kind) == want, f"fused_train/{width}: {kind} "
                                            f"ran {bodies.get(kind)}, not "
                                            f"{want}")
        for kind in ("dq", "dkv"):
            check(not bodies.get(kind), f"fused_train/{width}: {kind} ran "
                                        f"{bodies.get(kind)}")
        record["depth2_bf16"] = train_grads_agree(
            batch, dtype=torch.bfloat16, impls=("pallas_fused",), **kw)
        emit(**record)
        records[width] = record
    return records


# -- block-sparse attention: K3, and K4's visible walk ------------------------

SPARSE_BLOCK = 16


def sparse_layout(n, device="cuda", causal=True):
    """(n, n) bool: the pairs K3 computes (layout and causal triangle)."""
    from dalle_pytorch_tpu_torch.ops import sparse as SP
    return SP.structural_mask(n, SPARSE_BLOCK, causal=causal, device=device)


def sparse_bound(dtype, b, h, n, d, pairs) -> tuple:
    """(least ms, 'bytes' | 'operations') of one K3 call: the products
    over the layout's allowed pairs (what this data needs) at the peak
    rate of the inputs' type, against q, k, v and the key mask read once
    and out, m and l written once at the HBM rate."""
    flops = 4 * d * pairs * b * h
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * h * n * d * isz + 2 * b * h * n * 4 + b * n
    rate = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sparse_case(dtype, masked: bool, timed: bool, causal: bool = True,
                **shape) -> dict:
    import torch.nn.functional as F
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    q, k, v, _, mask = flash_inputs(dtype, masked, **shape)
    b, h, n, d = q.shape
    name = case_name(dtype, masked, d)
    if not causal:
        name = f"{name}/noncausal/n{n}"
    rtol, atol = flash_tolerances(dtype)
    kw = dict(scale=FLASH_SCALE, causal=causal, block=SPARSE_BLOCK,
              mask=mask)
    out, m, l = BS.block_sparse_attention_fwd(q, k, v, **kw)
    out_p, m_p, l_p = BS.block_sparse_attention_fwd_plain(q, k, v, **kw)
    errs = {"out": held(f"K3 {name} out", out, out_p, rtol, atol),
            "m": held(f"K3 {name} m", m, m_p, rtol, atol),
            "l": held(f"K3 {name} l", l, l_p, 1e-4, 1e-4)}
    record = {"case": name, "rtol": rtol, "atol": atol, "max_abs_err": errs,
              "atol_needed": atol_needed(out, out_p, rtol)}
    # the call runs the body the dispatch names (bfloat16 on the tensor
    # cores up to d 128 and at 192 and 256; the rest on CUDA cores; []:
    # the profiler recorded none of its launches)
    record["body"] = sparse_bodies(
        lambda: BS.block_sparse_attention_fwd(q, k, v, **kw))
    want = BS.kernel_body(dtype, d)
    check(record["body"] in ([want], []),
          f"K3 {name} ran {record['body']}, not {want}")
    if not timed:
        return record
    layout = sparse_layout(n, causal=causal)
    pairs = int(layout.sum())
    bms, by = sparse_bound(dtype, b, h, n, d, pairs)
    # the library yardstick: SDPA with the layout (and the pad keys) as a
    # boolean mask is the same function while every row sees a live key
    # (key 0, in the global block, is live in every case here)
    allowed = layout if not masked else layout & mask[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        q, k, v, attn_mask=allowed, scale=FLASH_SCALE)
    record.update(
        allowed_pairs_per_bh=pairs,
        ms=cuda_ms(lambda: BS.block_sparse_attention_fwd(q, k, v, **kw),
                   iters=50, warmup=5),
        device_us_per_launch=named_device_us(
            lambda: BS.block_sparse_attention_fwd(q, k, v, **kw),
            "block_sparse_fwd"),
        plain_ms=cuda_ms(lambda: BS.block_sparse_attention_fwd_plain(
            q, k, v, **kw), iters=3, warmup=1),
        bound_ms=bms, bound_by=by,
        sdpa_masked_ms=cuda_ms(sdpa, iters=20, warmup=2),
        sdpa_masked_device_us=all_device_us(sdpa),
        sdpa_max_abs_diff=float((sdpa().float() - out.float()).abs().max()))
    return record


def sparse_bodies(fn, calls: int = 12, attempts: int = 3) -> list:
    """The K3 ``__global__`` functions that ``calls`` profiled calls of
    ``fn`` ran (as ``BS.kernel_body`` names them)."""
    return launched_bodies(fn, K3_NAME, calls, attempts)


def sparse_bwd_check() -> dict:
    """Both backward routes at the north shapes in float32, with pad
    keys: the autograd Function against autograd through
    ``sparse_attention_ref``; each gradient to 2e-4 of its largest
    element (f32 sums in another order)."""
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import sparse as SP
    q, k, v, do, mask = flash_inputs(torch.float32, True)
    kw = dict(scale=FLASH_SCALE, causal=True, block=SPARSE_BLOCK, mask=mask)

    def grads(fn, **extra):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, **kw, **extra)
        return torch.autograd.grad(out, leaves, do)

    want = grads(SP.sparse_attention_ref)
    out = {}
    n = q.shape[2]
    for route, tile in (("static", 128), ("blockwise", 96)):
        static = (BS._static_tile_schedule(tile, tile, SPARSE_BLOCK,
                                           4 * SPARSE_BLOCK, (0,), True)
                  == [0] and n % tile == 0 and n > tile)
        check(static == (route == "static"), f"tile {tile} does not take "
              f"the {route} backward at n {n}")
        got = grads(BS.block_sparse_attention, block_q=tile, block_k=tile)
        worst = 0.0
        for g, w, what in zip(got, want, "qkv"):
            largest = float(w.abs().max())
            err = float((g - w).abs().max())
            check(err <= 2e-4 * largest, f"K3 {route} backward: d{what} "
                  f"differs from autograd of the oracle (max abs "
                  f"{err:.3e}, largest {largest:.3e})")
            worst = max(worst, err / largest)
        out[route] = {"tile": tile, "max_grad_err_of_largest": worst}
    return out


def visible_inputs(dtype, page_size=16, heads=8, dh=64, L=1280, seed=0):
    """Serving shapes, one slot per position of interest, every slot's
    pages mapped in random order; the mask is a sparse layer's (causal
    and its layout row), so the prefix walk over the same rows sees the
    same keys."""
    from dalle_pytorch_tpu_torch.ops import sparse as SP
    pos = torch.tensor([0, 1, 15, 16, 17, 63, 64, 65, 1279],
                       dtype=torch.int32, device="cuda")
    slots = len(pos)
    g = torch.Generator(device="cuda").manual_seed(seed)
    mp = L // page_size
    P = slots * mp + 1
    bt = (torch.randperm(P - 1, generator=g, device="cuda") + 1) \
        .reshape(slots, mp).to(torch.int32)
    vis, _, ccnt = (torch.from_numpy(a.copy()).to("cuda") for a in
                    SP.visible_pages_causal(L, page_size, SPARSE_BLOCK))
    p = pos.long()
    allowed = (torch.arange(L, device="cuda")[None] < pos[:, None]) \
        & sparse_layout(L)[p]
    allowed[4, 3] = False                                # a padded row
    q = torch.randn((slots, heads, dh), generator=g, device="cuda")
    shape = (P, heads, page_size, dh)
    sc = {}
    if dtype == torch.int8:
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device="cuda",
                                dtype=torch.int8) for _ in range(2))
        sc = {name: 0.01 + 0.09 * torch.rand(shape[:-1], generator=g,
                                             device="cuda")
              for name in ("k_scales", "v_scales")}
        q = q.to(torch.bfloat16)
    else:
        kp, vp = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                  for _ in range(2))
        q = q.to(dtype)
    walk = {"visible": vis[p], "visible_cnt": ccnt[p]}
    return (q, kp, vp, bt, pos, allowed), sc, walk


def visible_bound(q, kp, walk, scales) -> tuple:
    """``walk_bound`` of the visible walk: the listed pages, their count
    and list entries read from ``visible_cnt`` and ``visible`` (the
    walk reads no ``pos``)."""
    pages = int(walk["visible_cnt"].sum())
    return walk_bound(q, kp, pages, (walk["visible_cnt"].numel() + pages) * 4,
                      scales)


def visible_case(name, dtype, rtol, atol, heads=8, dh=64) -> dict:
    """K4's visible walk at ``visible_inputs``' shapes against its plain
    version, and the prefix walk over the same rows, with K4's
    tolerances; timed beside its bound. Above dh 128 the profiler must
    name the wide split body, and the CUDA-core wide body it replaces is
    held and timed too."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    args, sc, walk = visible_inputs(dtype, heads=heads, dh=dh)
    kw = dict(scale=FLASH_SCALE, **sc)
    got = PA.paged_decode_attention(*args, **kw, **walk)
    prefix = PA.paged_decode_attention(*args, **kw)
    want = PA.paged_decode_attention_plain(*args, **kw, **walk)
    mag = PA.paged_decode_attention_plain(args[0], args[1], args[2].abs(),
                                          *args[3:], **kw, **walk)[0]
    torch.cuda.synchronize()
    err = partials_held(f"K4 visible {name}", got, want, mag, rtol, atol)
    # the prefix walk over the same fully masked rows is the same function
    partials_held(f"K4 prefix walk, {name} sparse rows", prefix, want, mag,
                  rtol, atol)
    check(float(got[1][0, 0]) == PA.FILL
          and float(got[2][0].abs().max()) == 0.0,
          f"K4 visible {name}: the pos-0 slot must return (0, FILL, 0)")
    bms, by = visible_bound(args[0], args[1], walk, sc)
    call = lambda: PA.paged_decode_attention(*args, **kw,   # noqa: E731
                                             **walk)
    body = PA.kernel_body(args[1].dtype, dh, visible=True)
    rec = {"max_abs_err": err, "rtol": rtol, "atol": atol,
           "pages_walked": int(walk["visible_cnt"].sum()),
           "ms": cuda_ms(call, iters=200),
           "device_us_per_launch": named_device_us(call, body + "<",
                                                   iters=50),
           "prefix_walk_ms": cuda_ms(lambda: PA.paged_decode_attention(
               *args, **kw), iters=200),
           "plain_ms": cuda_ms(lambda: PA.paged_decode_attention_plain(
               *args, **kw, **walk), iters=50),
           "bound_ms": bms, "bound_by": by}
    if dh > 128:
        ran = launched_bodies(call, K4_NAME)
        check(ran == [body], f"K4 visible {name}: ran {ran}, not [{body}]")
        rec["body"] = body
        with k4_cuda_core_route():
            rec["cuda_core_max_abs_err"] = partials_held(
                f"K4 visible {name} CUDA-core body", call(), want, mag,
                rtol, atol)
            rec["cuda_core_device_us_per_launch"] = named_device_us(
                call, "paged_decode_wide_kernel<", iters=50)
    return rec


def phase_sparse_kernels() -> dict:
    results = {"k3": {}, "k4_visible": {}}
    for dtype in (torch.bfloat16, torch.float32):
        for masked in (False, True):
            rec = sparse_case(dtype, masked, timed=not masked)
            results["k3"][rec["case"]] = rec
            emit(phase="sparse_kernels", kernel="K3", ok=True, **rec)
    for d in (16, 48):               # padded to the kernel's 64
        for dtype in (torch.bfloat16, torch.float32):
            rec = sparse_case(dtype, True, timed=False, b=2, h=2, n=300, d=d)
            results["k3"][rec["case"]] = rec
            emit(phase="sparse_kernels", kernel="K3", ok=True, **rec)
    # heads above 128: the wide body, untimed at d 192 and 320, timed at
    # heads=2, dim_head=256
    for d in WIDE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for masked in (False, True):
                rec = sparse_case(dtype, masked, timed=False, b=2, h=2,
                                  n=300, d=d)
                results["k3"][rec["case"]] = rec
                emit(phase="sparse_kernels", kernel="K3", ok=True, **rec)
    rec = sparse_case(torch.bfloat16, False, timed=True, **WIDE_TIMED)
    results["k3"][rec["case"]] = rec
    emit(phase="sparse_kernels", kernel="K3", ok=True, **rec)
    # causal=False at the CLIP encoders' shapes: the text encoder's 256
    # tokens with caption padding, the visual encoder's 64 patches
    for n, masked in ((256, True), (64, False)):
        for dtype in (torch.bfloat16, torch.float32):
            rec = sparse_case(dtype, masked, timed=dtype == torch.bfloat16,
                              causal=False, b=8, h=8, n=n, d=64)
            results["k3"][rec["case"]] = rec
            emit(phase="sparse_kernels", kernel="K3", ok=True, **rec)
    results["k3_backward"] = sparse_bwd_check()
    emit(phase="sparse_kernels", kernel="K3 backward", ok=True,
         **results["k3_backward"])
    for name, (dtype, rtol, atol) in {
            "float32": (torch.float32, 1e-5, 1e-5),
            "bfloat16": (torch.bfloat16, 1e-2, 1e-2),
            "int8": (torch.int8, 1e-5, 1e-4)}.items():
        rec = visible_case(name, dtype, rtol, atol)
        results["k4_visible"][name] = rec
        emit(phase="sparse_kernels", kernel="K4 visible", case=name, ok=True,
             **rec)
        if dtype == torch.float32:
            continue
        # the wide serving width, heads=2, dim_head=256: the wide split
        # body's visible twin
        key = f"{name}/dh256/h2"
        rec = visible_case(key, dtype, rtol, atol, heads=2, dh=256)
        results["k4_visible"][key] = rec
        emit(phase="sparse_kernels", kernel="K4 visible", case=key, ok=True,
             **rec)
    return results


def sparse_counts(reset: bool = False) -> dict:
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    if reset:
        BS.block_sparse_attention_fwd.launches = 0
    return {"k3": BS.block_sparse_attention_fwd.launches,
            **flash_counts(reset)}


def sparse_train_cfg(**kw):
    """BASELINE config 4 (``bench.py::build_cfg(tiny=False, depth=64,
    sparse=True)``) with the flash kernels on its dense layers; dropout
    stays 0, as build_cfg leaves it."""
    import dataclasses
    depth = kw.pop("depth", 64)
    base = dict(depth=depth, sparse_attn=(True, False) * (depth // 2),
                sparse_impl="pallas", attn_impl="flash",
                attn_bwd_impl="pallas", loss_chunk=256)
    base.update(kw)
    return dataclasses.replace(north_cfg(), **base)


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the attention modules call the plain PyTorch
    versions of K1, K2a, K2b and K3 in place of their kernel wrappers,
    also on CUDA tensors: the yardstick of a kernel path in its own dtype
    (no kernel launches, so no launch counts)."""
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    swaps = ((FA, "flash_attention_fwd", FA.flash_attention_fwd_plain),
             (FA, "flash_attention_bwd_dq", FA.flash_attention_bwd_dq_plain),
             (FA, "flash_attention_bwd_dkv",
              FA.flash_attention_bwd_dkv_plain),
             (BS, "block_sparse_attention_fwd",
              BS.block_sparse_attention_fwd_plain))
    kept = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, kept):
            setattr(mod, name, fn)


def sparse_grads_agree(batch, dtype=torch.float32, **cfg_kw) -> dict:
    """Depth 2, full width: one step's loss and every gradient with the
    kernels (K3 'pallas', the dense layer's flash kernels with the split
    backward) against a yardstick. float32: the dense oracle ('ref'),
    loss to rtol 1e-5, each gradient to 1e-4 of its largest element.
    bfloat16: the same model on the kernels' plain versions
    (``plain_kernels``; the 'ref' oracle rounds its scores and softmax to
    bf16 and is no yardstick there), loss to rtol 2e-2 and each gradient
    to 1e-2 of its norm (relative Frobenius error). The largest element
    is no yardstick in bf16 here: the embedding gradients, summed over
    the batch's positions in bf16, differ between the kernels and the
    plain versions by 2-3 bf16 roundings of their largest element (2-2.4 %
    of it, at either width, with K3 or the flash kernels alone swapped),
    while a kernel fault (a tile left out, a wrong mask) moves many
    elements and so the norm. Both measures are recorded."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    f32 = dtype == torch.float32
    loss_rtol, grad_rtol = (1e-5, 1e-4) if f32 else (2e-2, 1e-2)
    enc = V.vae_encoder_init(north_cfg().vae, seed=7, dtype=dtype)
    key = prng.prng_key(5, device="cuda")
    got = {}
    for run in ("ref", "pallas"):
        impl = "ref" if run == "ref" and f32 else "pallas"
        model = D.dalle_init(sparse_train_cfg(depth=2, sparse_impl=impl,
                                              **cfg_kw),
                             seed=8, dtype=dtype)
        plain = run == "ref" and not f32
        before = sparse_counts()
        with plain_kernels() if plain else contextlib.nullcontext():
            loss = dalle_loss_fn(enc)(model, batch, key)
            loss.backward()
        check(not plain or sparse_counts() == before,
              f"sparse train: the plain run launched kernels "
              f"({before} -> {sparse_counts()})")
        got[run] = (float(loss.detach()), {n: p.grad.float() for n, p in
                                           model.named_parameters()})
        del model
    ref_loss, ref = got["ref"]
    loss, grads = got["pallas"]
    check(math.isfinite(loss)
          and abs(loss - ref_loss) <= loss_rtol * abs(ref_loss),
          f"sparse train: loss {loss} against ref {ref_loss}")
    rel = rel_norm = 0.0
    for name, g in grads.items():
        largest = float(ref[name].abs().max())
        err = float((g - ref[name]).abs().max())
        err_norm = float((g - ref[name]).norm()) / max(
            float(ref[name].norm()), 1e-30)
        if f32:
            check(err <= grad_rtol * max(largest, 1e-30),
                  f"sparse train: grad {name} differs from ref (max abs "
                  f"{err:.3e}, largest {largest:.3e})")
        else:
            check(err_norm <= grad_rtol,
                  f"sparse train: grad {name} differs from the plain "
                  f"versions' by {err_norm:.3e} of its norm")
        rel = max(rel, err / max(largest, 1e-30))
        rel_norm = max(rel_norm, err_norm)
    return {"loss": loss, "ref_loss": ref_loss, "max_grad_err_of_largest": rel,
            "max_grad_err_of_norm": rel_norm,
            "tolerance": {"loss_rtol": loss_rtol,
                          "grad_of_largest" if f32 else "grad_of_norm":
                              grad_rtol}}


def sparse_train_run(cfg, phase: str) -> tuple:
    """6 training steps of the block-sparse ``cfg`` (bfloat16 params, the
    smoke's batch, Adam lr 1e-4), the first a warm-up: finite losses, K3
    launched once a sparse layer and K1, K2a and K2b once a dense layer
    each step; then a profile window. Returns (record, batch)."""
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer, step_rng
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import (dalle_loss_fn,
                                                         make_train_step)
    n_sparse = sum(cfg.transformer.sparse_pattern)
    enc = V.vae_encoder_init(cfg.vae, seed=7, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=6, dtype=torch.bfloat16)
    args = types.SimpleNamespace(lr=1e-4, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)
    step = make_train_step(dalle_loss_fn(enc),
                           make_optimizer(args, model.parameters()))
    batch = train_batch(cfg)
    root = prng.prng_key(0, device="cuda")

    def key(i):
        return step_rng(root, i)

    steps, warmup = 6, 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sparse_counts(reset=True)
    losses = [step(model, batch, key(i)) for i in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(model, batch, key(i)) for i in range(warmup, steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - warmup)
    counts = sparse_counts()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"{phase} losses {losses}")
    for k, n in counts.items():
        want = n_sparse * steps if k == "k3" else \
            (cfg.depth - n_sparse) * steps
        check(n == want, f"{phase}: {k} launched {n} times, expected {want}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = batch["text"].shape[0] * cfg.seq_len
    prof = train_profile(step, model, batch, key)
    del model, step
    torch.cuda.empty_cache()
    record = dict(phase=phase, ok=True, depth=cfg.depth,
                  heads=cfg.heads, dim_head=cfg.dim_head,
                  sparse_layers=n_sparse, steps=steps, losses=losses,
                  ms_per_step=ms, tokens_per_step=tokens,
                  tokens_per_s=tokens / ms * 1e3, peak_mem_gib=peak_gib,
                  launches=counts, profile=prof)
    return record, batch


def phase_sparse_train() -> dict:
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    cfg = sparse_train_cfg()
    record, batch = sparse_train_run(cfg, "sparse_train")
    n_sparse = record["sparse_layers"]
    # the plain sparse backward (static route) of one layer, north shapes
    q, k, v, do, mask = flash_inputs(torch.bfloat16, False)
    out, m, l = BS.block_sparse_attention_fwd(
        q, k, v, scale=FLASH_SCALE, causal=True, block=SPARSE_BLOCK,
        mask=mask)
    bwd_ms = cuda_ms(lambda: BS.block_sparse_attention_bwd(
        q, k, v, mask, do, out, (m, l), scale=FLASH_SCALE, causal=True,
        block=SPARSE_BLOCK, num_local_blocks=4, global_blocks=(0,), bq=128,
        bk=128), iters=5, warmup=1)
    del q, k, v, do, out, m, l
    record.update(plain_sparse_bwd_ms_per_layer=bwd_ms,
                  plain_sparse_bwd_ms_per_step=bwd_ms * n_sparse,
                  depth2_f32=sparse_grads_agree(batch))
    emit(**record)
    return record


# the block-sparse config's width split as heads=2, dim_head=256, as
# WIDE_TRAIN splits the dense one
WIDE_SPARSE = dict(heads=2, dim_head=256)


def phase_wide_sparse_train() -> dict:
    """The ``sparse_train`` phase's step at ``WIDE_SPARSE``: K3 on its
    wide tensor-core body in the 32 sparse layers, K1, K2a and K2b split
    on theirs in the 32 dense ones, each launched 32 x steps times and
    named in the profile, none of the CUDA-core wide bodies; then a
    depth-2 copy in bfloat16 against the same model on the kernels' plain
    versions."""
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import flash_attention as FA
    cfg = sparse_train_cfg(**WIDE_SPARSE)
    record, batch = sparse_train_run(cfg, "wide_sparse_train")
    n_sparse = record["sparse_layers"]
    prof = record["profile"]
    ran = prof.get("body_launches_per_step", {})
    want = {BS.kernel_body(torch.bfloat16, cfg.dim_head): n_sparse}
    for kind in ("fwd", "dq", "dkv"):
        want[FA.kernel_body(kind, torch.bfloat16, cfg.dim_head)] = \
            cfg.depth - n_sparse
    # the profile names exactly these bodies, each at most its launches a
    # step (a session may drop the records of its first milliseconds; the
    # wrappers' counts above are exact)
    check(set(ran) == set(want), f"wide_sparse_train ran {sorted(ran)}, "
                                 f"not {sorted(want)}")
    for body, n in want.items():
        check(0 < ran[body] <= n, f"wide_sparse_train: {body} {ran[body]} "
                                  f"launches a step, expected {n}")
    losses = record["losses"]
    check(losses[-1] < losses[0], f"wide_sparse_train: losses {losses} do "
                                  f"not fall")
    record["depth2_bf16"] = sparse_grads_agree(batch, dtype=torch.bfloat16,
                                               **WIDE_SPARSE)
    emit(**record)
    return record


def sparse_serve_cfg(depth: int = 12):
    import dataclasses
    return dataclasses.replace(north_cfg(), depth=depth,
                               sparse_attn=(True, False) * (depth // 2))


def sparse_decode_check() -> dict:
    """Float32, full width: the sparse-reads step through K4's visible
    walk against the trimmed-gather oracle, then 64 greedy steps with
    identical tokens from the kernel and gather sparse reads and from
    the sparse-reads-off step (prefix walk under the layout mask)."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    cfg = sparse_serve_cfg()
    tcfg = cfg.transformer
    model = D.dalle_init(cfg, seed=1, dtype=torch.float32)
    slots, ps, L = 8, 16, cfg.seq_len
    mp = -(-L // ps)
    P = slots * mp + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    shape = (tcfg.depth, P, tcfg.heads, ps, tcfg.dim_head)
    pool = {"k": torch.randn(shape, generator=g, device="cuda"),
            "v": torch.randn(shape, generator=g, device="cuda")}
    pools = {name: {k: v.clone() for k, v in pool.items()}
             for name in ("kernel", "gather", "off")}
    del pool
    bt = (torch.arange(P - 1, device="cuda") + 1).reshape(slots, mp) \
        .to(torch.int32)
    pos = torch.tensor([0, 1, 15, 16, 17, 300, 640, 1000],
                       dtype=torch.int32, device="cuda")
    key_mask = torch.ones((slots, L), dtype=torch.bool, device="cuda")
    active = torch.ones((slots,), dtype=torch.bool, device="cuda")
    tok = torch.randint(0, cfg.num_text_tokens, (slots,), generator=g,
                        device="cuda").to(torch.int32)
    kw = dict(cfg=tcfg, key_mask=key_mask, active=active)
    modes = {"kernel": dict(sparse_reads=True),
             "gather": dict(sparse_reads=True, attn_impl="gather"),
             "off": dict()}
    worst = 0.0
    with torch.no_grad():
        for step in range(64):
            x = D.decode_token_embed(model, tok, pos)
            hs = {name: decode_ops.decode_step_paged(
                model.transformer, x, pos, pools[name], bt, **kw, **mode)
                for name, mode in modes.items()}
            if step == 0:
                check(torch.allclose(hs["kernel"], hs["gather"], rtol=1e-4,
                                     atol=1e-4),
                      f"sparse decode: kernel h_out differs from the "
                      f"gather oracle (max abs "
                      f"{float((hs['kernel'] - hs['gather']).abs().max()):.3e})")
            worst = max(worst, float((hs["kernel"] - hs["gather"]).abs()
                                     .max()))
            forbid = D.logits_mask(cfg, pos)
            toks = {name: D.to_logits(model, h).masked_fill(
                forbid, -math.inf).argmax(-1) for name, h in hs.items()}
            check(torch.equal(toks["kernel"], toks["gather"])
                  and torch.equal(toks["kernel"], toks["off"]),
                  f"sparse decode step {step}: greedy tokens differ")
            t_k = toks["kernel"]
            tok = torch.where(pos + 1 >= cfg.text_seq_len,
                              t_k - cfg.num_text_tokens, t_k) \
                .to(torch.int32)
            pos = pos + 1
    return {"steps": 64, "slots": slots, "max_abs_h_diff": worst}


def phase_sparse_engine() -> dict:
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    decode = sparse_decode_check()
    cfg = sparse_serve_cfg(SERVE_DEPTH)
    n_sparse = sum(cfg.transformer.sparse_pattern)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    reqs = engine_requests(cfg)
    post = PostProcessor(vae, model)
    queue = S.RequestQueue(max_prompt_len=cfg.text_seq_len)
    engine = Engine(model, queue, num_slots=8, chunk_steps=8, kv="paged",
                    page_size=16, paged_attn="kernel", sparse_reads=True,
                    complete=post)
    handles = [queue.submit(r) for r in reqs]
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    PA.paged_decode_attention.visible_launches = 0
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"visible": PA.paged_decode_attention.visible_launches,
                "prefix": PA.paged_decode_attention.launches}
    results = [h.result(timeout=0) for h in handles]
    check_engine_results(cfg, reqs, results)
    steps = engine.decode_steps
    check(launches["visible"] == n_sparse * steps
          and launches["prefix"] == (cfg.depth - n_sparse) * steps,
          f"K4 launched {launches} times over {steps} decode steps, "
          f"expected {n_sparse} x steps of each walk")
    check(engine.alloc.in_use == 0, f"{engine.alloc.in_use} pages leaked")
    stats = engine.stats()
    image_tokens = len(reqs) * cfg.image_seq_len
    prof = profile_decode(engine, queue, reqs,
                          [res.tokens for res in results])
    check(engine.alloc.in_use == 0, "pages leaked after the profiled run")
    record = dict(phase="sparse_engine", ok=True, decode_f32=decode,
                  requests=len(reqs), wall_s=wall, decode_steps=steps,
                  ms_per_decode_step=wall * 1e3 / steps,
                  tokens_per_s=stats["tokens_decoded"] / wall,
                  image_tokens_per_s=image_tokens / wall,
                  harvests=stats["harvests"], pages_peak=stats["pages_peak"],
                  kv_read_bytes_per_token=stats["kv_read_bytes_per_token"],
                  kv_read_bytes_per_token_dense_reads=stats[
                      "kv_read_bytes_per_token_dense_reads"],
                  k4_launches=launches, profile=prof)
    emit(**record)
    return record


# -- serving at heads=2, dim_head=256: K4's wide split body -------------------

WIDE_SERVE = dict(heads=2, dim_head=256)


def wide_serve_cfg(**kw):
    import dataclasses
    return dataclasses.replace(north_cfg(), **WIDE_SERVE, **kw)


def wide_decode_check() -> dict:
    """bfloat16, full width at ``WIDE_SERVE``: one ``decode_step_paged``
    through K4 (the wide split body) against the gather oracle
    (``attn_impl='gather'``), with random bf16 pages and with the same
    rows as an int8 cache (quantized per row as the engine quantizes
    them), at the ``decode`` phase's positions. h_out is held to 2e-2 of
    its norm (relative Frobenius error): the oracle's scores and softmax
    are bf16 (``_gather_read`` computes in q's dtype) where the kernel's
    are f32, and every layer rounds its activations to bf16 on both
    sides, so the two differ by a few bf16 roundings (2^-8 relative
    each) compounded over the 12 layers, not by one. K4 must launch once
    a layer on the wide split body."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    cfg = wide_serve_cfg()
    tcfg = cfg.transformer
    model = D.dalle_init(cfg, seed=1, dtype=torch.bfloat16)
    slots, ps, L = 8, 16, cfg.seq_len
    mp = -(-L // ps)
    P = slots * mp + 1
    g = torch.Generator(device="cuda").manual_seed(2)
    shape = (tcfg.depth, P, tcfg.heads, ps, tcfg.dim_head)
    bf16 = {n: torch.randn(shape, generator=g, device="cuda")
            .to(torch.bfloat16) for n in ("k", "v")}
    # the same rows quantized as the engine's int8 cache holds them
    pools = {"bfloat16": bf16,
             "int8": decode_ops._rows(bf16["k"], bf16["v"], True)}
    bt = (torch.arange(P - 1, device="cuda") + 1).reshape(slots, mp) \
        .to(torch.int32)
    pos = torch.tensor([0, 1, 15, 16, 17, 300, 640, 1000],
                       dtype=torch.int32, device="cuda")
    key_mask = torch.ones((slots, L), dtype=torch.bool, device="cuda")
    active = torch.ones((slots,), dtype=torch.bool, device="cuda")
    tok = torch.randint(0, cfg.num_text_tokens, (slots,), generator=g,
                        device="cuda").to(torch.int32)
    kw = dict(cfg=tcfg, key_mask=key_mask, active=active)
    out = {}
    with torch.no_grad():
        x = D.decode_token_embed(model, tok, pos)
        for name, pool in pools.items():
            oracle = {k: v.clone() for k, v in pool.items()}
            before = PA.paged_decode_attention.launches
            step = lambda: decode_ops.decode_step_paged(   # noqa: E731
                model.transformer, x, pos, pool, bt, **kw)
            h_k = step()
            launched = PA.paged_decode_attention.launches - before
            h_g = decode_ops.decode_step_paged(model.transformer, x, pos,
                                               oracle, bt,
                                               attn_impl="gather", **kw)
            torch.cuda.synchronize()
            rel = float((h_k.float() - h_g.float()).norm()
                        / h_g.float().norm())
            check(launched == tcfg.depth and rel <= 2e-2
                  and bool(torch.isfinite(h_k).all()),
                  f"wide decode step ({name} cache): K4 launched {launched}"
                  f" times, h_out off the gather oracle by {rel:.3e} of "
                  f"its norm")
            body = PA.kernel_body(pool["k"].dtype, tcfg.dim_head)
            ran = launched_bodies(step, K4_NAME, calls=2)
            check(ran == [body], f"wide decode step ({name} cache): K4 "
                                 f"ran {ran}, not [{body}]")
            out[name] = {"h_out_rel_err": rel, "rel_tol": 2e-2,
                         "max_abs_h_diff": float((h_k.float() - h_g.float())
                                                 .abs().max()),
                         "body": body}
    return out


def serve_wide(cfg, reqs, sparse_reads: bool) -> dict:
    """The bfloat16 engine at ``cfg`` on ``reqs`` (8 slots, K = 8, page
    16), profiled early and late inside its one run: every result ok,
    each walk's K4 launches (the visible walk in the sparse layers, the
    prefix walk in the others) = its layers x decode steps, every page
    freed, and the profiles naming the wide split body of each walk that
    ran, nothing else of K4."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    n_sparse = sum(cfg.transformer.sparse_pattern) if sparse_reads else 0
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    post = PostProcessor(vae, model)
    queue = S.RequestQueue(max_prompt_len=cfg.text_seq_len)
    engine = Engine(model, queue, num_slots=8, chunk_steps=8, kv="paged",
                    page_size=16, paged_attn="kernel",
                    sparse_reads=sparse_reads, complete=post)
    check(engine.num_pages == 1 + 8 * 80, "pool must be 1 + 8*80 pages")
    handles = [queue.submit(r) for r in reqs]
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    PA.paged_decode_attention.visible_launches = 0
    t0 = time.perf_counter()
    prof = profile_run(engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"visible": PA.paged_decode_attention.visible_launches,
                "prefix": PA.paged_decode_attention.launches}
    results = [h.result(timeout=0) for h in handles]
    check_engine_results(cfg, reqs, results)
    steps = engine.decode_steps
    check(launches["visible"] == n_sparse * steps
          and launches["prefix"] == (cfg.depth - n_sparse) * steps,
          f"K4 launched {launches} times over {steps} decode steps, "
          f"expected {n_sparse} visible and {cfg.depth - n_sparse} prefix "
          f"walks a step")
    check(engine.alloc.in_use == 0, f"{engine.alloc.in_use} pages leaked")
    want = sorted(PA.kernel_body(engine.pool["k"].dtype, cfg.dim_head, vis)
                  for vis, n in ((True, n_sparse),
                                 (False, cfg.depth - n_sparse)) if n)
    for name, window in prof.items():
        check(window.get("k4_bodies") == want,
              f"{name} window: K4 ran {window.get('k4_bodies')}, not {want}")
    stats = engine.stats()
    return dict(requests=len(reqs), wall_s=wall, decode_steps=steps,
                ms_per_decode_step=wall * 1e3 / steps,
                tokens_per_s=stats["tokens_decoded"] / wall,
                image_tokens_per_s=len(reqs) * cfg.image_seq_len / wall,
                harvests=stats["harvests"], pages_peak=stats["pages_peak"],
                kv_read_bytes_per_token=stats["kv_read_bytes_per_token"],
                k4_launches=launches, k4_bodies=want, profile=prof,
                tokens=[list(r.tokens) for r in results], engine=engine,
                queue=queue)


def phase_wide_engine() -> dict:
    """Serving at ``WIDE_SERVE`` (the north width as heads=2,
    dim_head=256): the bf16 decode check at full depth, then, at
    ``SERVE_DEPTH``, the engine on the six requests of the
    ``engine`` phase (the wall includes its two profile windows), a
    re-run of the 256-token request alone with the same tokens, every
    page freed; then with the sparse pattern and ``sparse_reads=True`` on
    three of them (prompts of 1, 17 and 256 tokens; no re-run, to keep
    the smoke's time)."""
    record = {"decode_bf16": wide_decode_check()}
    emit(phase="wide_engine", check="decode_bf16", ok=True,
         **record["decode_bf16"])
    cfg = wide_serve_cfg(depth=SERVE_DEPTH)
    reqs = engine_requests(cfg)
    dense = serve_wide(cfg, reqs, sparse_reads=False)
    engine, queue = dense.pop("engine"), dense.pop("queue")
    again = queue.submit(reqs[2])
    engine.run_until_idle()
    check(again.result(timeout=0).ok and list(again.result().tokens)
          == dense["tokens"][2], "wide engine: re-run request gave other "
                                 "tokens")
    check(engine.alloc.in_use == 0, "pages leaked after the re-run")
    del dense["tokens"], engine, queue
    record["dense"] = dense
    emit(phase="wide_engine", engine="dense", ok=True, **dense)
    scfg = wide_serve_cfg(depth=SERVE_DEPTH,
                          sparse_attn=(True, False) * (SERVE_DEPTH // 2))
    sparse = serve_wide(scfg, engine_requests(scfg)[:3], sparse_reads=True)
    for k in ("engine", "queue", "tokens"):
        sparse.pop(k)
    record["sparse_reads"] = sparse
    emit(phase="wide_engine", engine="sparse_reads", ok=True, **sparse)
    return record


# -- one-shot generation: dense KV decode, guidance, int8, the CLIP rerank ---

def dense_decode_check() -> dict:
    """The dense-cache decode step against the paged path's gather oracle
    (``decode_step_paged`` with ``attn_impl='gather'``, which reads
    through ``paged_view``) at full width in float32: a 17-token prompt
    prefilled into the dense cache, the same rows laid out as a page
    pool, one step's h_out to 1e-4, then 64 greedy steps with identical
    tokens, each cache written by its own path."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    cfg = north_cfg()
    tcfg = cfg.transformer
    model = D.dalle_init(cfg, seed=1, dtype=torch.float32)
    rows, t0, L, ps = 4, 17, cfg.seq_len, 16
    mp = L // ps
    g = torch.Generator(device="cuda").manual_seed(6)
    text = torch.randint(1, cfg.num_text_tokens, (rows, t0), generator=g,
                         device="cuda")

    def as_pages(buf):
        """(depth, rows, heads, L, dh) -> (depth, 1 + rows * mp, heads,
        ps, dh): slot i's rows on pages 1 + i * mp ..., trash page 0."""
        d_, r_, hh, _, dh = buf.shape
        pages = buf.reshape(d_, r_, hh, mp, ps, dh).permute(0, 1, 3, 2, 4, 5)
        pages = pages.reshape(d_, r_ * mp, hh, ps, dh)
        return torch.cat([torch.zeros_like(pages[:, :1]), pages], dim=1)

    worst = 0.0
    with torch.no_grad():
        h, cache = decode_ops.prefill(model.transformer,
                                      D.embed_prompt(model, text), cfg=tcfg,
                                      total_len=L)
        pool = {k: as_pages(v) for k, v in cache.items()}
        bt = (torch.arange(rows * mp, device="cuda") + 1).reshape(rows, mp) \
            .to(torch.int32)
        key_mask = decode_ops._full_key_mask(None, rows, t0, L, "cuda")
        active = torch.ones((rows,), dtype=torch.bool, device="cuda")

        def greedy(hh, pos):
            forbid = D.logits_mask(cfg, torch.full((rows,), pos - 1,
                                                   device="cuda"))
            t = D.to_logits(model, hh).masked_fill(forbid, -math.inf) \
                .argmax(-1)
            return torch.where(t >= cfg.num_text_tokens,
                               t - cfg.num_text_tokens, t)

        tok = greedy(h[:, -1], t0)
        for step in range(64):
            pos = t0 + step
            posv = torch.full((rows,), pos, dtype=torch.int32, device="cuda")
            x = D.decode_token_embed(model, tok, posv)
            h_d = decode_ops.decode_step(model.transformer, x, pos, cache,
                                         cfg=tcfg, key_mask=key_mask)
            h_p = decode_ops.decode_step_paged(
                model.transformer, x, posv, pool, bt, cfg=tcfg,
                key_mask=key_mask, active=active, attn_impl="gather")
            if step == 0:
                check(torch.allclose(h_d, h_p, rtol=1e-4, atol=1e-4),
                      f"dense decode step differs from the paged gather "
                      f"oracle (max abs {float((h_d - h_p).abs().max()):.3e})")
            worst = max(worst, float((h_d - h_p).abs().max()))
            t_d, t_p = greedy(h_d, pos + 1), greedy(h_p, pos + 1)
            check(torch.equal(t_d, t_p),
                  f"dense decode step {step}: greedy tokens differ")
            tok = t_d
    return {"steps": 64, "rows": rows, "prompt_len": t0,
            "max_abs_h_diff": worst}


def clip_check(clip, g) -> dict:
    """CLIP scores with K3 (``sparse_impl='pallas'``, causal=False in all
    12 layers) against the dense layout oracle (``'ref'``) on the same
    captions and images, at the reference's published widths: the
    rerank's call (no mask) and one with caption padding. float32 to
    rtol/atol 1e-4 (f32 sums in other orders); bfloat16 to atol 1e-2,
    a few bf16 roundings (2^-8 relative) of scores bounded by exp(1):
    twelve layers round on either side, in other places. K3 must launch
    12 times a call."""
    import copy
    import dataclasses
    from dalle_pytorch_tpu_torch.models import clip as C
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    cfg = clip.cfg
    text = torch.randint(1, cfg.num_text_tokens, (4, cfg.text_seq_len),
                         generator=g, device="cuda")
    mask = torch.arange(cfg.text_seq_len, device="cuda")[None] < \
        torch.tensor([[17], [256], [1], [100]], device="cuda")
    size = cfg.visual_image_size
    images = torch.rand((4, size, size, 3), generator=g, device="cuda") * 2 \
        - 1
    out = {}
    for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-4)),
                       (torch.bfloat16, dict(rtol=0.0, atol=1e-2))):
        model = clip if dtype == torch.bfloat16 else C.clip_init(
            cfg, seed=7, dtype=torch.float32)
        ref = copy.copy(model)
        ref.cfg = dataclasses.replace(cfg, sparse_impl="ref")
        name = str(dtype).split(".")[-1]
        with torch.no_grad():
            for case, m in (("rerank", None), ("padded", mask)):
                before = BS.block_sparse_attention_fwd.launches
                got = C.clip_apply(model, text, images.to(dtype),
                                   text_mask=m)
                torch.cuda.synchronize()
                launched = BS.block_sparse_attention_fwd.launches - before
                want = C.clip_apply(ref, text, images.to(dtype), text_mask=m)
                err = float((got.float() - want.float()).abs().max())
                check(launched == 12, f"CLIP {name} {case}: K3 launched "
                                      f"{launched} times, not 12")
                check(bool(torch.isfinite(got).all()) and torch.allclose(
                    got.float(), want.float(), **tol),
                    f"CLIP {name} {case}: K3 scores differ from 'ref' (max "
                    f"abs {err:.3e})")
                out[f"{name}/{case}"] = {"max_abs_err": err, **tol,
                                         "scores": got.float().tolist()}
    return out


def generate_profile(model, text, key, opts, window=(300, 16)) -> tuple:
    """``sample_tokens`` (``generate_images``' loop) run to its end with
    the same options: its tokens, and from step ``window[0]`` on,
    ``window[1]`` steps timed without the profiler, then as many under
    torch.profiler (device ms, kernels per step, the device's idle share
    against the unprofiled wall)."""
    from torch.profiler import ProfilerActivity, profile
    from dalle_pytorch_tpu_torch.models import dalle as D
    start, n = window
    prof = profile(activities=[ProfilerActivity.CUDA])
    toks, marks = [], {}
    for i, tok in enumerate(D.sample_tokens(model, text, rng=key, **opts)):
        toks.append(tok)
        if i in (start, start + n, start + 2 * n):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()
            if i == start + n:
                prof.start()
            elif i == start + 2 * n:
                prof.stop()
    wall_ms = (marks[start + n] - marks[start]) * 1e3 / n
    kernels = device_kernels(prof)
    total_us = sum(us for us, _ in kernels.values())
    rec = {"first_step": start, "steps": n, "wall_ms_per_step": wall_ms,
           "wall_ms_per_step_profiled":
               (marks[start + 2 * n] - marks[start + n]) * 1e3 / n}
    if total_us <= 0:
        rec["device_ms_per_step"] = "not measured"
    else:
        device_ms = total_us / 1e3 / n
        rec.update(device_ms_per_step=device_ms,
                   device_idle_share=max(0.0, 1 - device_ms / wall_ms),
                   kernels_launched_per_step=sum(
                       c for _, c in kernels.values()) / n,
                   top_kernels_ms_per_step=top_kernels(kernels, n),
                   kinds_ms_per_step=kernel_classes(kernels, n))
    return torch.stack(toks, dim=1), rec


# depth of the ``generate`` phase's sampling model, cut from 12 to keep
# the smoke's time with the ``serve_features`` phase (the step is
# host-bound, about linear in depth)
GENERATE_DEPTH = 2


def phase_generate() -> dict:
    """One-shot generation at the north width (its sampling model at
    ``GENERATE_DEPTH``): the dense decode check, the CLIP check, then
    ``generate_images`` twice: 4 full 256-token
    prompts with guidance 3.0, and int8 weights with an int8 cache on 17
    tokens with top-p 0.9. Each: a run returning the image ids (ids in
    [0, 2048), finite images), a run with the CLIP rerank (K3 12 times,
    finite scores, the same images), and ``sample_tokens`` with the same
    key again (identical ids; the guided run's profile window)."""
    from dalle_pytorch_tpu_torch.models import clip as C
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    import dataclasses
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import prng
    record = {"dense_decode": dense_decode_check()}
    emit(phase="generate", check="dense_decode", ok=True,
         **record["dense_decode"])
    import dalle_pytorch_tpu_torch as facades
    cfg = dataclasses.replace(north_cfg(), depth=GENERATE_DEPTH)
    # the models through the package root's reference facades
    vae = facades.DiscreteVAE(**dataclasses.asdict(cfg.vae), seed=3,
                              dtype=torch.bfloat16)
    model = facades.DALLE(
        dim=cfg.dim, vae=vae, depth=cfg.depth, seed=4,
        dtype=torch.bfloat16, num_text_tokens=cfg.num_text_tokens,
        text_seq_len=cfg.text_seq_len, heads=cfg.heads,
        dim_head=cfg.dim_head)
    check(model.cfg == cfg, "generate: the facade built another config")
    # the reference CLIP at its published defaults, K3 in every layer
    clip = facades.CLIP(sparse_impl="pallas", seed=7, dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(8)
    record["clip"] = clip_check(clip, g)
    emit(phase="generate", check="clip", ok=True, **record["clip"])
    runs = {
        "guided": (model, torch.randint(1, cfg.num_text_tokens, (4, 256),
                                        generator=g, device="cuda"),
                   dict(guidance=3.0)),
        "int8": (D.quantize_for_decode(model),
                 torch.randint(1, cfg.num_text_tokens, (4, 17), generator=g,
                               device="cuda"),
                 dict(top_p=0.9, quantize_cache=True)),
    }
    k3_launches = 0
    for name, (m, text, opts) in runs.items():
        key = prng.prng_key(11, device="cuda")
        b, t0 = text.shape
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        images, img_seq = D.generate_images(m, vae, text, rng=key,
                                            return_img_seq=True, **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        check(img_seq.shape == (b, cfg.image_seq_len)
              and int(img_seq.min()) >= 0
              and int(img_seq.max()) < cfg.num_image_tokens,
              f"generate {name}: bad image tokens")
        size = cfg.vae.image_size
        check(images.shape == (b, size, size, 3)
              and bool(torch.isfinite(images).all()),
              f"generate {name}: bad images {tuple(images.shape)}")
        # the main path with the rerank: K3's count from 0; the guided
        # run through the facade's own generate_images
        BS.block_sparse_attention_fwd.launches = 0
        t_start = time.perf_counter()
        if name == "guided":
            images_r, scores = m.generate_images(text, rng=key, clip=clip,
                                                 **opts)
        else:
            images_r, scores = D.generate_images(m, vae, text, rng=key,
                                                 clip=clip, **opts)
        torch.cuda.synchronize()
        wall_rerank = time.perf_counter() - t_start
        launched = BS.block_sparse_attention_fwd.launches
        k3_launches += launched
        check(launched == 12, f"generate {name}: K3 launched {launched} "
                              f"times in the rerank, not 12")
        check(scores.shape == (b,) and bool(torch.isfinite(scores).all()),
              f"generate {name}: bad CLIP scores")
        image_diff = float((images_r.float() - images.float()).abs().max())
        check(image_diff <= 1e-2, f"generate {name}: the rerank run's "
                                  f"images differ by {image_diff:.3e}")
        window = (300, 16) if name == "guided" else None
        if window:
            toks, prof = generate_profile(m, text, key, opts, window)
        else:
            toks = torch.stack(list(D.sample_tokens(m, text, rng=key,
                                                    **opts)), dim=1)
            prof = None
        check(torch.equal(toks[:b, -cfg.image_seq_len:], img_seq),
              f"generate {name}: a re-run with the same key gave other "
              f"tokens")
        steps = cfg.seq_len - t0
        rec = {"prompts": b, "prompt_len": t0, **opts,
               "rows": b * (2 if opts.get("guidance", 0) > 0 else 1),
               "wall_s_per_call": wall, "wall_s_with_rerank": wall_rerank,
               "decode_steps": steps, "ms_per_decode_step": wall * 1e3 / steps,
               "images_per_s": b / wall, "k3_launches_rerank": launched,
               "scores": scores.float().tolist(),
               "rerank_image_max_abs_diff": image_diff}
        if prof is not None:
            rec["profile"] = prof
        record[name] = rec
        emit(phase="generate", run=name, ok=True, **rec)
    record["k3_launches"] = k3_launches
    return record


# -- the rest of training: VAE, reversible, MoE, CLIP, remat ------------------

def slice_optimizer(model):
    """Adam lr 1e-4, constant, no clip: the smoke's optimizer."""
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer
    args = types.SimpleNamespace(lr=1e-4, lr_schedule="constant",
                                 warmup_steps=0, decay_steps=0,
                                 lr_end_ratio=0.1, n_epochs=1,
                                 clip_grad_norm=0.0)
    return make_optimizer(args, model.parameters())


def slice_train(phase: str, model, loss_fn, batch, want: dict, units: int,
                steps: int = 6, warmup: int = 1, after=None,
                profile: bool = True) -> dict:
    """``steps`` steps of ``make_train_step(loss_fn)`` under Adam lr 1e-4
    on ``model``, the first ``warmup`` untimed: finite losses, and each
    kernel's launches a step (K1, K2a, K2b, K3) equal to ``want``. Wall ms
    a step, ``units`` (tokens or images) a step and a second, peak
    memory, and a profile window (``train_profile``: device ms a step,
    the idle share). ``after(model)`` runs after every step (the EMA)."""
    from dalle_pytorch_tpu_torch.cli.common import step_rng
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import make_train_step
    train_step = make_train_step(loss_fn, slice_optimizer(model))

    def step(m, b, k):
        loss = train_step(m, b, k)
        if after is not None:
            after(m)
        return loss

    root = prng.prng_key(0, device="cuda")

    def key(i):
        return step_rng(root, i)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sparse_counts(reset=True)
    losses = [step(model, batch, key(i)) for i in range(warmup)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step(model, batch, key(i)) for i in range(warmup, steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (steps - warmup)
    counts = sparse_counts()
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"{phase} losses {losses}")
    per_step = {k: n / steps for k, n in counts.items()}
    for k, n in want.items():
        check(per_step[k] == n, f"{phase}: {k} launched {per_step[k]} "
                                f"times a step, expected {n}")
    record = dict(phase=phase, ok=True, steps=steps, losses=losses,
                  ms_per_step=ms, units_per_step=units,
                  units_per_s=units / ms * 1e3,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  launches=counts, launches_per_step=per_step)
    if profile:
        record["profile"] = train_profile(step, model, batch, key)
    return record


def kernels_vs_plain(what: str, make_model, loss_fn, batch, key,
                     dtype=torch.bfloat16) -> dict:
    """One step's loss and every gradient of ``make_model(dtype)`` with
    the kernels against the same weights on the kernels' plain versions
    (``plain_kernels``). float32: loss to rtol 1e-5, each gradient to
    1e-4 of its norm (relative Frobenius error). bfloat16: both bf16
    paths are also held against a float32 copy of the same weights on
    the plain versions, the truth: the loss to rtol 2e-2 of the plain
    bf16 loss, and each gradient tensor's error to the truth at most
    twice the plain bf16 path's own error, or 1e-2 of its norm where
    that is larger; the same for all gradients together (one vector),
    which is where a scalar's gradient is held. A fixed share of the
    norm is no yardstick for every bf16 gradient: CLIP's temperature
    gradient (the mean diagonal similarity minus its softmax-weighted
    mean) and its patch-embedding bias (a sum over 512 patch rows) come
    from terms that nearly cancel, and there the plain bf16 path misses
    the truth by percents as well; a scalar's error is one draw of that
    rounding noise (the temperature's: 9.8 % with the kernels, 4.3 % on
    the plain versions, on the H100), so it is recorded, and float32
    holds it to 1e-4. The kernel run must launch kernels and the plain
    ones none."""
    import copy
    f32 = dtype == torch.float32
    base = make_model(dtype)
    runs = (("plain", dtype), ("kernels", dtype)) + \
        ((("truth", torch.float32),) if not f32 else ())
    got = {}
    for run, dt in runs:
        model = copy.deepcopy(base).to(dt)
        b_ = {k: v.to(dt) if v.is_floating_point() else v
              for k, v in batch.items()}
        before = sparse_counts()
        with contextlib.nullcontext() if run == "kernels" else \
                plain_kernels():
            loss = loss_fn(model, b_, key)
            loss.backward()
        torch.cuda.synchronize()
        ran = {k: n - before[k] for k, n in sparse_counts().items()}
        check((run == "kernels") == (sum(ran.values()) > 0),
              f"{what}: the {run} run launched {ran}")
        got[run] = (float(loss.detach()), {n: p.grad.float() for n, p in
                                           model.named_parameters()}, ran)
        del model
    ref_loss, plain, _ = got["plain"]
    loss, grads, ran = got["kernels"]
    loss_rtol = 1e-5 if f32 else 2e-2
    check(math.isfinite(loss)
          and abs(loss - ref_loss) <= loss_rtol * abs(ref_loss),
          f"{what}: loss {loss} against the plain versions' {ref_loss}")

    def rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    def flat(gs):
        return torch.cat([g.reshape(-1) for g in gs.values()])

    worst = worst_plain = 0.0
    scalars = {}
    for name, g in grads.items():
        if f32:
            err, tol = rel(g, plain[name]), 1e-4
        else:
            truth = got["truth"][1][name]
            err, err_plain = rel(g, truth), rel(plain[name], truth)
            if g.dim() == 0:
                scalars[name] = {"err": err, "plain_err": err_plain}
                continue
            tol = max(2 * err_plain, 1e-2)
            worst_plain = max(worst_plain, err_plain)
        check(err <= tol, f"{what}: grad {name} off by {err:.3e} of its "
                          f"norm (allowed {tol:.3e})")
        worst = max(worst, err)
    out = {"dtype": str(dtype).split(".")[-1], "loss": loss,
           "plain_loss": ref_loss, "kernel_launches": ran}
    if f32:
        out.update(max_grad_err_of_norm=worst,
                   tolerance={"loss_rtol": 1e-5, "grad_of_norm": 1e-4})
        return out
    truth = flat(got["truth"][1])
    err_all, plain_all = rel(flat(grads), truth), rel(flat(plain), truth)
    check(err_all <= max(2 * plain_all, 1e-2),
          f"{what}: the gradients off by {err_all:.3e} of their norm "
          f"(plain {plain_all:.3e})")
    out.update(truth_loss=got["truth"][0], max_grad_err_to_f32=worst,
               plain_max_grad_err_to_f32=worst_plain,
               all_grads_err_to_f32=err_all,
               plain_all_grads_err_to_f32=plain_all,
               scalar_grads_err_to_f32=scalars,
               tolerance={"loss_rtol": 2e-2,
                          "grad_to_f32": "max(2 x plain's, 1e-2)"})
    return out


def id_batch(cfg, b=8, seed=9) -> dict:
    """Random text ids with padded tails (rows 1 and 3), the text mask and
    random image ids, made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.ones((b, cfg.text_seq_len), dtype=torch.bool, device="cuda")
    mask[1, 200:] = False
    mask[3, 17:] = False
    return {"text": torch.randint(1, cfg.num_text_tokens,
                                  (b, cfg.text_seq_len), generator=g,
                                  device="cuda"),
            "mask": mask,
            "image": torch.randint(0, cfg.num_image_tokens,
                                   (b, cfg.image_seq_len), generator=g,
                                   device="cuda")}


def no_kernels() -> dict:
    return {"k1": 0, "k2a": 0, "k2b": 0, "k3": 0}


# BASELINE config 1 (``bench.py::bench_vae``)
VAE_TRAIN = dict(image_size=256, num_tokens=2048, codebook_dim=256,
                 num_layers=3, hidden_dim=128)


def phase_vae_train() -> dict:
    """BASELINE config 1 (``bench.py::bench_vae``): the DiscreteVAE at 256
    px, 2,048 codes of 256, 3 layers, hidden 128, bfloat16, batch 8, the
    training scripts' loss (``vae_loss_fn(smooth_l1=True)``: Huber +
    mse), Adam lr 1e-4, an EMA at decay 0.999 updated after every step:
    6 steps with finite losses, no attention kernel, the float32 EMA
    moving; and the Gumbel noise's ms a step (one (8, 32, 32, 2048)
    bfloat16 draw through the int64 threefry)."""
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_ema
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import vae_loss_fn
    cfg = V.VAEConfig(**VAE_TRAIN)
    vae = V.discrete_vae_init(cfg, seed=21, dtype=torch.bfloat16)
    ema, update = make_ema(types.SimpleNamespace(ema_decay=0.999), vae)
    start = {n: e.clone() for n, e in ema.items()}
    g = torch.Generator(device="cuda").manual_seed(22)
    size = cfg.image_size
    images = (torch.rand((8, size, size, 3), generator=g, device="cuda") * 2
              - 1).to(torch.bfloat16)
    record = slice_train("vae_train", vae, vae_loss_fn(cfg, smooth_l1=True),
                         {"images": images}, no_kernels(), units=8,
                         after=lambda m: update(ema, m))
    moved = max(float((ema[n] - start[n]).abs().max()) for n in ema)
    check(all(e.dtype == torch.float32 for e in ema.values())
          and moved > 0, f"vae_train: the EMA did not move ({moved})")
    shape = (8, cfg.grid_size, cfg.grid_size, cfg.num_tokens)
    key = prng.prng_key(3, device="cuda")
    noise_ms = cuda_ms(lambda: prng.gumbel(key, shape, torch.bfloat16),
                       iters=5, warmup=1)
    record.update(images_per_s=record["units_per_s"], ema_max_move=moved,
                  ema_dtype="float32", gumbel_noise_shape=list(shape),
                  gumbel_noise_ms_per_step=noise_ms,
                  gumbel_share_of_step=noise_ms / record["ms_per_step"])
    emit(**record)
    return record


def rev_cfg(**kw):
    """BASELINE config 3 (``bench.py::build_cfg(depth=12,
    reversible=True)``) on the flash kernels with the split backward,
    ``loss_chunk`` 256, dropout 0 (build_cfg's)."""
    return train_cfg(**{**dict(reversible=True, attn_dropout=0.0,
                               ff_dropout=0.0), **kw})


def phase_rev_train() -> dict:
    """The reversible DALLE: 6 steps with finite losses, K1 launched 24
    times a step (the forward and the backward's recompute, 2 x depth),
    K2a and K2b 12 each; peak memory beside 2 steps of the same config
    with ``reversible=False``; then at depth 2 with dropout 0.1, the
    kernels against their plain versions (``kernels_vs_plain``) in
    bfloat16 and float32."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    cfg = rev_cfg()
    batch = id_batch(cfg)
    model = D.dalle_init(cfg, seed=31, dtype=torch.bfloat16)
    d = cfg.depth
    record = slice_train("rev_train", model, dalle_loss_fn(), batch,
                         {"k1": 2 * d, "k2a": d, "k2b": d, "k3": 0},
                         units=8 * cfg.seq_len)
    del model
    torch.cuda.empty_cache()
    seq = D.dalle_init(rev_cfg(reversible=False), seed=31,
                       dtype=torch.bfloat16)
    seq_rec = slice_train("rev_train/sequential", seq, dalle_loss_fn(),
                          batch, {"k1": d, "k2a": d, "k2b": d, "k3": 0},
                          units=8 * cfg.seq_len, steps=2, profile=False)
    del seq
    torch.cuda.empty_cache()
    key = prng.prng_key(5, device="cuda")
    depth2 = {}
    for dtype in (torch.bfloat16, torch.float32):
        c2 = rev_cfg(depth=2, attn_dropout=0.1, ff_dropout=0.1)
        depth2[str(dtype).split(".")[-1]] = kernels_vs_plain(
            "rev_train depth 2",
            lambda dt, c2=c2: D.dalle_init(c2, seed=32, dtype=dt),
            dalle_loss_fn(), batch, key, dtype=dtype)
    record.update(tokens_per_s=record["units_per_s"],
                  sequential={k: seq_rec[k] for k in (
                      "ms_per_step", "peak_mem_gib", "launches_per_step",
                      "losses")},
                  peak_mem_ratio_rev_to_seq=record["peak_mem_gib"]
                  / seq_rec["peak_mem_gib"],
                  depth2=depth2)
    emit(**record)
    return record


def phase_rev_decode() -> dict:
    """Decoding the reversible config: one float32 step at depth 12
    through K4 against the gather oracle and 64 greedy steps
    (``paged_decode_check``: the two-stream layer loop, K/V from x2);
    then the bfloat16 engine at ``SERVE_DEPTH`` on one request (17-token
    prompt) to its
    1,024 image tokens: ok, K4 launched depth x decode steps times, every
    page freed."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    import dataclasses
    step = paged_decode_check(dataclasses.replace(north_cfg(),
                                                  reversible=True))
    cfg = dataclasses.replace(north_cfg(), reversible=True,
                              depth=SERVE_DEPTH)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=33, vae=vae, dtype=torch.bfloat16)
    req = engine_requests(cfg)[1]
    queue = S.RequestQueue(max_prompt_len=cfg.text_seq_len)
    engine = Engine(model, queue, num_slots=8, chunk_steps=8, kv="paged",
                    page_size=16, paged_attn="kernel",
                    complete=PostProcessor(vae, model))
    handle = queue.submit(req)
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PA.paged_decode_attention.launches
    res = handle.result(timeout=0)
    check_engine_results(cfg, [req], [res])
    check(launches == cfg.depth * engine.decode_steps,
          f"rev_decode: K4 launched {launches} times, expected depth x "
          f"decode steps = {cfg.depth * engine.decode_steps}")
    check(engine.alloc.in_use == 0,
          f"rev_decode: {engine.alloc.in_use} pages leaked")
    record = dict(phase="rev_decode", ok=True, f32_step=step,
                  engine_wall_s=wall, decode_steps=engine.decode_steps,
                  ms_per_decode_step=wall * 1e3 / engine.decode_steps,
                  image_tokens=len(res.tokens),
                  image_tokens_per_s=len(res.tokens) / wall,
                  k4_launches=launches)
    emit(**record)
    return record


def phase_moe_train() -> dict:
    """``bench.py::bench_moe``: the north width at depth 12 with every FF
    a top-2 MoE of 8 experts, flash with the split backward,
    ``loss_chunk`` 256, dropout 0: 6 steps with finite losses, K1, K2a
    and K2b 12 launches a step each; the load-balance loss finite and
    positive, and the training loss equal to the CE plus
    ``moe_aux_coef * aux``."""
    import dataclasses
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.ops import transformer as T
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    cfg = dataclasses.replace(train_cfg(attn_dropout=0.0, ff_dropout=0.0),
                              moe_experts=8)
    batch = id_batch(cfg)
    model = D.dalle_init(cfg, seed=41, dtype=torch.bfloat16)
    d = cfg.depth
    record = slice_train("moe_train", model, dalle_loss_fn(), batch,
                         {"k1": d, "k2a": d, "k2b": d, "k3": 0},
                         units=8 * cfg.seq_len)
    key = prng.prng_key(7, device="cuda")
    with torch.no_grad():
        loss = float(D.dalle_apply(model, batch["text"], batch["image"],
                                   mask=batch["mask"], rng=key, train=True,
                                   return_loss=True))
        tokens = D.embed_prompt(model, batch["text"], batch["image"])
        mask = torch.cat([batch["mask"], torch.ones_like(batch["image"],
                                                         dtype=torch.bool)],
                         dim=1)
        h, aux = T.transformer_apply(model.transformer, tokens,
                                     cfg=cfg.transformer, mask=mask, rng=key,
                                     train=True, with_aux=True)
        ce = float(D.ce_from_hidden(model, h, batch["text"], batch["image"]))
    aux = float(aux)
    check(math.isfinite(aux) and aux > 0, f"moe_train: aux loss {aux}")
    check(abs(loss - (ce + cfg.moe_aux_coef * aux)) <= 1e-5 * abs(loss),
          f"moe_train: loss {loss} is not ce {ce} + {cfg.moe_aux_coef} x "
          f"aux {aux}")
    del model
    torch.cuda.empty_cache()
    record.update(tokens_per_s=record["units_per_s"], aux_loss=aux, ce=ce,
                  loss_with_aux=loss, moe_aux_coef=cfg.moe_aux_coef,
                  experts=cfg.moe_experts, k=cfg.moe_k)
    emit(**record)
    return record


def clip_batch(cfg, b=8, seed=51) -> dict:
    """Captions with padded tails of several lengths, and images in
    [-1, 1), made on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lengths = torch.tensor([256, 17, 1, 100, 255, 64, 200, 3],
                           device="cuda")[:b]
    size = cfg.visual_image_size
    return {"text": torch.randint(1, cfg.num_text_tokens,
                                  (b, cfg.text_seq_len), generator=g,
                                  device="cuda"),
            "mask": torch.arange(cfg.text_seq_len, device="cuda")[None]
            < lengths[:, None],
            "images": torch.rand((b, size, size, 3), generator=g,
                                 device="cuda") * 2 - 1}


# the reference CLIP's published defaults, K3 in every layer
CLIP_TRAIN = dict(sparse_impl="pallas")


def phase_clip_train() -> dict:
    """CLIP at ``CLIPConfig()``'s defaults (512 wide, 6 + 6 layers of 8
    heads, text 256, 64 patches of 32 px) with ``sparse_impl='pallas'``,
    bfloat16, batch 8 with padded captions: 6 steps with finite losses,
    K3 (``causal=False``) 12 launches a step, the forward of each layer
    (its backward is the plain blockwise one); then at depth 2 + 2 the
    kernels against their plain versions in bfloat16 and float32."""
    import dataclasses
    from dalle_pytorch_tpu_torch.models import clip as C
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import clip_loss_fn
    cfg = C.CLIPConfig(**CLIP_TRAIN)
    batch = clip_batch(cfg)
    model = C.clip_init(cfg, seed=52, dtype=torch.bfloat16)
    layers = cfg.text_enc_depth + cfg.visual_enc_depth
    record = slice_train("clip_train", model, clip_loss_fn(), {
        **batch, "images": batch["images"].to(torch.bfloat16)},
        {"k1": 0, "k2a": 0, "k2b": 0, "k3": layers}, units=8)
    del model
    torch.cuda.empty_cache()
    c2 = dataclasses.replace(cfg, text_enc_depth=2, visual_enc_depth=2)
    key = prng.prng_key(0, device="cuda")
    depth2 = {}
    for dtype in (torch.bfloat16, torch.float32):
        depth2[str(dtype).split(".")[-1]] = kernels_vs_plain(
            "clip_train depth 2",
            lambda dt: C.clip_init(c2, seed=53, dtype=dt),
            clip_loss_fn(), {**batch, "images": batch["images"].to(dtype)},
            key, dtype=dtype)
    record.update(images_per_s=record["units_per_s"], depth2=depth2)
    emit(**record)
    return record


# K1 launches a step per layer under each remat mode
REMAT_K1 = {"none": 1, "save_ln": 1, "dots": 2, "full": 2}


def phase_remat() -> dict:
    """The north ``train_cfg`` at dropout 0 under each remat mode: 2 steps
    from the same weights, the first step's loss identical across modes
    and the second's within 1e-3 relative of 'none''s, peak memory per
    mode, and K1's launches a step (``REMAT_K1``: 'dots' and 'full'
    recompute it in the backward; K2a and K2b once a layer in every
    mode); then at depth 2, each mode's gradients with the kernels
    against 'none''s, each to 1e-2 of its norm."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.train import dalle_loss_fn
    batch = id_batch(north_cfg())
    key = prng.prng_key(5, device="cuda")
    modes, grads2, runs = {}, {}, {}
    for mode, k1 in REMAT_K1.items():
        cfg = train_cfg(remat=mode, attn_dropout=0.0, ff_dropout=0.0)
        model = D.dalle_init(cfg, seed=61, dtype=torch.bfloat16)
        d = cfg.depth
        rec = slice_train(f"remat/{mode}", model, dalle_loss_fn(), batch,
                          {"k1": k1 * d, "k2a": d, "k2b": d, "k3": 0},
                          units=8 * cfg.seq_len, steps=2, warmup=1,
                          profile=False)
        del model
        torch.cuda.empty_cache()
        runs[mode] = rec
        modes[mode] = {k: rec[k] for k in ("losses", "ms_per_step",
                                           "peak_mem_gib",
                                           "launches_per_step")}
        m2 = D.dalle_init(train_cfg(depth=2, remat=mode, attn_dropout=0.0,
                                    ff_dropout=0.0), seed=62,
                          dtype=torch.bfloat16)
        dalle_loss_fn()(m2, batch, key).backward()
        grads2[mode] = {n: p.grad.float() for n, p in m2.named_parameters()}
        del m2
    base = modes["none"]["losses"]
    worst = {}
    for mode, rec in modes.items():
        check(rec["losses"][0] == base[0],
              f"remat {mode}: first loss {rec['losses'][0]} != {base[0]}")
        check(abs(rec["losses"][1] - base[1]) <= 1e-3 * abs(base[1]),
              f"remat {mode}: second loss {rec['losses'][1]} against "
              f"{base[1]}")
        err = max(float((g - grads2["none"][n]).norm())
                  / max(float(grads2["none"][n].norm()), 1e-30)
                  for n, g in grads2[mode].items())
        check(err <= 1e-2, f"remat {mode}: depth-2 gradients differ from "
                           f"'none' by {err:.3e} of a norm")
        worst[mode] = err
    launches = {k: sum(rec["launches"][k] for rec in runs.values())
                for k in ("k1", "k2a", "k2b")}
    record = dict(phase="remat", ok=True, modes=modes,
                  depth2_max_grad_err_of_norm=worst, launches=launches)
    emit(**record)
    return record


# -- the CLIs: checkpoints, data and the training and generation entry points -

# the north config's VAE and DALLE as the CLIs' flags (``north_cfg``): codes
# of 512 so DALLE's image embedding ties to the codebook; bfloat16 params
# and ``loss_chunk`` 256 as the ``train`` phase's step
CLI_IMAGES = 16
CLI_VAE = ["--imageSize", "256", "--num_tokens", "2048", "--codebook_dim",
           "512", "--num_layers", "3", "--hidden_dim", "64"]
CLI_DALLE = ["--imageSize", "256", "--dim", "512", "--depth", "12",
             "--heads", "8", "--dim_head", "64", "--text_seq_len", "256",
             "--num_text_tokens", "10000", "--attn_impl", "flash",
             "--attn_bwd_impl", "pallas", "--param_dtype", "bfloat16",
             "--loss_chunk", "256", "--sample_every", "0"]
# CLIP at the north widths (``CLIPConfig``'s defaults) with two layers a
# tower, its sparse layers on the default 'ref' path
CLI_CLIP = ["--imageSize", "256", "--dim_text", "512", "--dim_image", "512",
            "--dim_latent", "512", "--num_text_tokens", "10000",
            "--text_seq_len", "256", "--text_enc_depth", "2",
            "--text_heads", "8", "--visual_enc_depth", "2",
            "--visual_heads", "8", "--visual_patch_size", "32"]
CLI_WORDS = ("red blue green gray small large square circle striped dotted "
             "bright dark a the on under beside of with and").split()


def cli_data(root: str, seed: int = 0) -> dict:
    """``CLI_IMAGES`` 256 px PNGs written by the port's encoder (smooth
    ramps plus seeded noise) under ``{root}/imagedata/0``, a captions
    corpus and its ``name : caption`` pairs; each image read back with
    the port's decoder must equal what was written. Returns the decode ms
    an image of these files, and of one written with every row filter
    (Sub, Average and Paeth chain along each row: the decoder's slow
    path)."""
    import numpy as np
    from dalle_pytorch_tpu_torch.data import images as I
    rng = np.random.default_rng(seed)
    folder = os.path.join(root, "imagedata", "0")
    os.makedirs(folder)
    ramp = np.linspace(0, 255, 256)
    written = {}
    for i in range(CLI_IMAGES):
        img = np.stack([ramp[None, :].repeat(256, 0),
                        ramp[:, None].repeat(256, 1),
                        np.full((256, 256), 16.0 * i)], axis=-1)
        img = np.clip(img + rng.normal(0, 24, img.shape), 0, 255)
        written[f"img{i:02d}.png"] = img.astype(np.uint8)
    for name, img in written.items():
        with open(os.path.join(folder, name), "wb") as f:
            f.write(I.encode_png(img))
    t0 = time.perf_counter()
    for name, img in written.items():
        check(np.array_equal(I.read_image(os.path.join(folder, name)), img),
              f"cli: {name} does not decode to the pixels written")
    plain_ms = (time.perf_counter() - t0) * 1e3 / len(written)
    filtered = I.encode_png(written["img00.png"],
                            filters=[r % 5 for r in range(256)])
    t0 = time.perf_counter()
    check(np.array_equal(I.decode_png(filtered), written["img00.png"]),
          "cli: the every-filter PNG does not decode to its pixels")
    filtered_ms = (time.perf_counter() - t0) * 1e3
    captions = [" ".join(rng.choice(CLI_WORDS,
                                    size=int(rng.integers(4, 12))))
                for _ in written]
    written_caption = captions[0]
    with open(os.path.join(root, "only.txt"), "w") as f:
        f.write("".join(c + "\n" for c in captions))
    with open(os.path.join(root, "pairs.txt"), "w") as f:
        f.write("".join(f"{n} : {c}\n" for n, c in zip(written, captions)))
    return {"png_decode_ms_per_image": plain_ms,
            "png_decode_ms_every_filter": filtered_ms,
            "png_bytes_per_image": os.path.getsize(
                os.path.join(folder, "img00.png")),
            "caption": written_caption}


def cli_flag(argv: list, name: str) -> int:
    return int(argv[argv.index(name) + 1])


def cli_step_ms(metrics_path: str, tokens_per_step: int) -> list:
    """ms a step from the CLI's own ``MetricsLogger`` records (tokens a
    second, one record a step at ``--log_interval 1``)."""
    out = []
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("tokens_per_sec"):
                out.append(tokens_per_step / rec["tokens_per_sec"] * 1e3)
    return out


def cli_codec(path: str) -> dict:
    """The msgpack codec's write and read rates on a checkpoint's params
    payload (host memory only: the tree is already on the host)."""
    from dalle_pytorch_tpu_torch.compat import msgpack
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    tree = msgpack.unpackb(data)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = msgpack.packb(tree)
    write_s = time.perf_counter() - t0
    check(again == data, "cli: the codec does not write back the bytes it "
                         "read")
    mb = len(data) / 1e6
    return {"params_mb": mb, "read_mb_per_s": mb / read_s,
            "write_mb_per_s": mb / write_s}


def cli_seeded_sync(train_dalle, dalle: list, dirs, vae_models: str,
                    root: str) -> dict:
    """``train_dalle --guard_transfers`` at depth 2 with a ``.item()``
    seeded into its step body (a wrapper of the ``train_step`` the CLI
    hands its loop): the guard must raise ``RuntimeError`` at that call
    on the first step, and restore the sync debug mode after."""
    import shutil
    shutil.copytree(vae_models, os.path.join(root, "s", "models"))
    real = train_dalle.run_supervised_loop
    calls = []

    def seeded(args, **kw):
        step = kw["train_step"]

        def with_sync(item, state):
            loss, payload = step(item, state)
            calls.append(state.global_step)
            loss.item()                 # an implicit device-to-host sync
            return loss, payload

        return real(args, **{**kw, "train_step": with_sync})

    argv = list(dalle)
    argv[argv.index("--depth") + 1] = "2"
    train_dalle.run_supervised_loop = seeded
    try:
        train_dalle.main(argv + dirs("s") + ["--n_epochs", "1",
                                             "--guard_transfers"])
        raised = None
    except RuntimeError as e:
        raised = str(e)
    finally:
        train_dalle.run_supervised_loop = real
    mode = torch.cuda.get_sync_debug_mode()
    check(raised is not None and "synchroniz" in raised and calls == [0],
          f"cli: the seeded sync under --guard_transfers gave {raised!r} "
          f"after steps {calls}")
    check(mode == 0, f"cli: the sync debug mode is {mode} after the guard")
    return {"seeded_sync_raised": raised[-300:], "mode_after": mode}


def cli_guarded_clip(train_clip, argv: list) -> dict:
    """``train_clip --guard_transfers`` (``CLI_CLIP``) for one epoch of 2
    steps: each step body must run with the sync debug mode at "error"
    (2) and raise nothing, and the mode must be back at 0 after."""
    from dalle_pytorch_tpu_torch.cli import common as CC
    real = CC.transfer_guard
    modes = []

    @contextlib.contextmanager
    def recording(device):
        with real(device):
            modes.append(torch.cuda.get_sync_debug_mode())
            yield

    CC.transfer_guard = recording
    try:
        train_clip.main(argv + ["--guard_transfers"])
    finally:
        CC.transfer_guard = real
    after = torch.cuda.get_sync_debug_mode()
    check(modes == [2] * (CLI_IMAGES // 8) and after == 0,
          f"cli: train_clip's step bodies ran under modes {modes}, "
          f"{after} after")
    return {"step_modes": modes, "mode_after": after}


def phase_cli(train: dict, keep: bool = False) -> dict:
    """The port's CLIs through ``main(argv)`` at the north width, in a
    temporary directory removed afterwards: ``cli_data``'s 16 PNGs;
    ``train_vae`` for one epoch of 2 steps at batch 8 (the north VAE)
    under ``--guard_transfers``;
    ``train_dalle`` at the north width (``CLI_DALLE``: flash with the
    split kernel backward, bfloat16, dropout 0.1, an EMA) for 2 epochs of
    2 steps, K1, K2a and K2b each launched 12 times a step; the same run
    again in two legs (epoch 0, then ``--auto_resume`` for epoch 1), each
    under ``--guard_transfers`` (every step body under
    ``set_sync_debug_mode("error")``), whose parameters, Adam state and
    EMA must equal the uninterrupted run's bit for bit; a guarded run at
    depth 2 whose step body a wrapper here seeds with a ``.item()`` must
    raise ``RuntimeError`` naming the synchronizing call, the mode
    restored after; ``train_clip`` (``CLI_CLIP``: its sparse 'ref'
    layers) for 2 steps under ``--guard_transfers``, each step body
    under the "error" mode (``cli_guarded_clip``); then ``gen_dalle`` from the epoch-1 checkpoint, 2
    images, seed 5, its caption from the corpus, whose grid PNG must
    decode to 260 x 518 x 3."""
    import shutil
    import tempfile
    from dalle_pytorch_tpu_torch import checkpoint as C
    from dalle_pytorch_tpu_torch.cli import (gen_dalle, train_clip,
                                             train_dalle, train_vae)
    from dalle_pytorch_tpu_torch.data import images as I
    root = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    try:
        record = dict(phase="cli", ok=True, **cli_data(root))
        common = ["--dataPath", os.path.join(root, "imagedata"),
                  "--batchSize", "8", "--log_interval", "1", "--seed", "3"]

        def run(name, main, argv):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            main(argv)
            torch.cuda.synchronize()
            record.setdefault("wall_s", {})[name] = time.perf_counter() - t0

        def dirs(sub):
            return ["--models_dir", os.path.join(root, sub, "models"),
                    "--results_dir", os.path.join(root, sub, "results"),
                    "--metrics", os.path.join(root, sub, "metrics.jsonl")]

        run("train_vae", train_vae.main, common + CLI_VAE + dirs("a") + [
            "--n_epochs", "1", "--guard_transfers"])
        vae_dir = os.path.join(root, "b", "models")
        shutil.copytree(os.path.join(root, "a", "models"), vae_dir)
        dalle = common + CLI_DALLE + [
            "--captions_only", os.path.join(root, "only.txt"),
            "--captions", os.path.join(root, "pairs.txt"), "--name", "north",
            "--ema_decay", "0.999"]
        torch.cuda.reset_peak_memory_stats()
        flash_counts(reset=True)
        run("train_dalle", train_dalle.main, dalle + dirs("a") + [
            "--n_epochs", "2"])
        launches = flash_counts()
        steps = 2 * (CLI_IMAGES // 8)
        depth = cli_flag(CLI_DALLE, "--depth")
        for k, n in launches.items():
            check(n == depth * steps, f"cli: {k} launched {n} times in "
                                      f"{steps} steps, expected "
                                      f"{depth * steps}")
        record["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        record["launches"] = launches
        record["launches_per_step"] = {k: n / steps for k, n in
                                       launches.items()}
        size = cli_flag(CLI_VAE, "--imageSize")
        grid = size // 2 ** cli_flag(CLI_VAE, "--num_layers")
        tokens = 8 * (cli_flag(CLI_DALLE, "--text_seq_len") + grid * grid)
        ms = cli_step_ms(os.path.join(root, "a", "metrics.jsonl"), tokens)
        record["train_dalle_ms_per_step"] = ms
        record["train_phase_ms_per_step"] = (train or {}).get("ms_per_step")

        # the same run in two legs: epoch 0, then --auto_resume, each
        # with every step body under the transfer guard
        run("train_dalle_leg0", train_dalle.main, dalle + dirs("b") + [
            "--n_epochs", "1", "--guard_transfers"])
        run("train_dalle_leg1", train_dalle.main, dalle + dirs("b") + [
            "--n_epochs", "1", "--auto_resume", "--guard_transfers"])
        record["guard"] = cli_seeded_sync(train_dalle, dalle, dirs,
                                          os.path.join(root, "a", "models"),
                                          root)
        t0 = time.perf_counter()
        record["guard"]["train_clip"] = cli_guarded_clip(
            train_clip, common + CLI_CLIP + [
                "--captions_only", os.path.join(root, "only.txt"),
                "--captions", os.path.join(root, "pairs.txt"),
                "--name", "clip"] + dirs("c") + ["--n_epochs", "1"])
        record.setdefault("wall_s", {})["train_clip"] = \
            time.perf_counter() - t0
        whole = os.path.join(root, "a", "models", "north_dalle-1")
        legs = os.path.join(root, "b", "models", "north_dalle-1")
        same = {}
        for fname in (C.PARAMS, C.OPT_STATE, C.EMA):
            with open(os.path.join(whole, fname), "rb") as f, \
                    open(os.path.join(legs, fname), "rb") as g:
                same[fname] = f.read() == g.read()
        if not all(same.values()):
            from dalle_pytorch_tpu_torch.compat import msgpack

            def leaves(t):
                if isinstance(t, dict):
                    for v in t.values():
                        yield from leaves(v)
                elif isinstance(t, list):
                    for v in t:
                        yield from leaves(v)
                else:
                    yield torch.as_tensor(t).float()

            diffs = {}
            for fname in same:
                with open(os.path.join(whole, fname), "rb") as f, \
                        open(os.path.join(legs, fname), "rb") as g:
                    a = msgpack.unpackb(f.read())
                    b = msgpack.unpackb(g.read())
                diffs[fname] = max(float((x - y).abs().max()) for x, y in
                                   zip(leaves(a), leaves(b)))
            record["resume_max_abs_diff"] = diffs
        check(all(same.values()), f"cli: the resumed run's payloads differ "
                                  f"from the uninterrupted run's: {same}, "
                                  f"{record.get('resume_max_abs_diff')}")
        record["resume_bit_equal"] = same
        manifest = C.load_manifest(whole)
        record["checkpoint_bytes"] = {k: v["bytes"] for k, v in
                                      manifest["payloads"].items()}
        t0 = time.perf_counter()
        C.restore_params(whole)
        record["restore_params_s"] = time.perf_counter() - t0
        record["codec"] = cli_codec(whole)

        run("gen_dalle", gen_dalle.main, [
            record.pop("caption"), "--name", "north",
            "--dalle_epoch", "1", "--num_images", "2", "--seed", "5",
            "--models_dir", os.path.join(root, "a", "models"),
            "--results_dir", os.path.join(root, "a", "gen")])
        (png,) = os.listdir(os.path.join(root, "a", "gen"))
        img = I.read_image(os.path.join(root, "a", "gen", png))
        want = (size + 4, 2 * size + 6, 3)       # 2 images, padding 2
        check(img.shape == want, f"cli: the grid is {img.shape}, not {want}")
        record["gen_grid_shape"] = list(img.shape)
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    emit(**record)
    # ``keep``: the data and the VAE stay for the ``parallel`` phase's CLI
    # run, which removes them
    return {**record, "root": root} if keep else record


# -- the single engine's serving features ------------------------------------

# a pool of four full sequences (80 pages of 16) and the trash page, under
# the 8 slots' 640: the growing slots run it dry and eviction must fire
FEATURE_PAGES = 1 + 4 * 80
FEATURE_ENGINE = dict(num_slots=8, chunk_steps=8, kv="paged", page_size=16,
                      paged_attn="kernel", prefix_cache=True,
                      num_pages=FEATURE_PAGES)
# the bfloat16 engines A, B and C run at SERVE_DEPTH (cut from 12 to keep
# the smoke's time with the ``http`` phase, which serves at 12):
# B's draft is one layer of the two
SPEC_K, SPEC_DRAFT = 4, 1
# the float32 runs that must give identical tokens, cut to fit the
# smoke's time: SERVE_DEPTH with a 1-layer draft, six of the eight
# requests (one guided pair and both shared prompts: seven slots of
# eight) capped at 256 image tokens, on a pool of four such sequences
# (32 pages each) and the trash page, so eviction still fires
IDENTITY_DEPTH, IDENTITY_DRAFT = SERVE_DEPTH, SPEC_DRAFT
IDENTITY_REQUESTS = (0, 2, 3, 4, 5, 6)
IDENTITY_GRID = 256
IDENTITY_PAGES = 1 + 4 * 32


def feature_requests(cfg) -> list:
    """Eight requests: prompts of 1, 17 and 256 tokens; two pairs that
    share a prompt (17 and 256 tokens: prefix hits); two guided at
    cfg_scale 3.0 at priority 0, both of 17 tokens (their null captions
    are one prefix entry), one sharing its prompt with an unguided
    request; the rest at priority 1 (eviction takes them first); top-k,
    top-p 0.9 and greedy sampling."""
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    g = torch.Generator().manual_seed(6)

    def prompt(n):
        return tuple(int(t) for t in torch.randint(
            1, cfg.num_text_tokens, (n,), generator=g))

    p1, p17a, p17b, p17c, p256 = (prompt(1), prompt(17), prompt(17),
                                  prompt(17), prompt(256))
    top_p = S.SamplingParams(top_p=0.9)
    greedy = S.SamplingParams(filter_thres=1.0)
    return [S.Request(p17b, seed=30, cfg_scale=3.0),
            S.Request(p17c, seed=31, cfg_scale=3.0, sampling=top_p),
            S.Request(p17b, seed=32, priority=1, sampling=greedy),
            S.Request(p17a, seed=33, priority=1),
            S.Request(p17a, seed=34, priority=1, sampling=top_p),
            S.Request(p256, seed=35, priority=1),
            S.Request(p256, seed=36, priority=1, sampling=greedy),
            S.Request(prompt(1), seed=37, priority=1)]


def pair_page_ratio(engine, samples: list):
    """Wrap ``engine._complete`` to record, as each request completes, the
    pages its slots hold (both slots of a guided pair), a page mapped by
    r owners counting 1/r: its share of the pool's residency."""
    orig = engine._complete

    def complete(i, slot, now):
        slots = [i] + ([slot.pair] if slot.pair is not None else [])
        own = sum(1 / engine.alloc.refcount(p) for j in slots
                  for p in engine._slot_pages[j])
        samples.append((slot.pair is not None, len(slot.handle.request.codes),
                        own))
        return orig(i, slot, now)

    engine._complete = complete


def idle_window(engine, chunks: int = 2) -> dict:
    """``chunks`` engine steps under torch.profiler (synchronised at both
    ends): device kernel ms a step, and the idle share against the
    window's own wall (an upper bound: the profiler's host cost is in
    that wall; ``run_summary`` takes it against the run's)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(chunks):
            engine.step_once()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = chunks * engine.chunk_steps
    kernels = device_kernels(prof)
    total_us = sum(us for us, _ in kernels.values())
    if total_us <= 0:
        return {"steps": steps, "device_ms_per_step": "not measured"}
    k4_us = sum(us for k, (us, _) in kernels.items() if "paged_decode" in k)
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": total_us / 1e3 / steps,
            "k4_ms_per_step": k4_us / 1e3 / steps,
            "device_idle_share_profiled": max(0.0,
                                              1 - total_us / 1e3 / wall_ms),
            "kernels_launched_per_step": sum(
                n for _, n in kernels.values()) / steps}


def feature_run(model, reqs, window: int = 0, post=None, probe=None,
                time_admissions: bool = False, **kw) -> dict:
    """One engine over ``reqs`` to the end: the results, wall seconds, K4
    launches (counted from 0 here), stats and counters; with ``window``
    a profiled window from that many steps in, after which ``probe(engine)``
    runs on the live state (its time left out of the wall, its launches
    out of the count). ``time_admissions`` synchronises the card around
    each admission to time it, so a run that gives a wall leaves it off."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    queue = S.RequestQueue(max_prompt_len=model.cfg.text_seq_len)
    engine = Engine(model, queue, complete=None if post is None
                    else post.submit, time_admissions=time_admissions,
                    **kw)
    pairs = []
    if engine.kv == "paged":
        pair_page_ratio(engine, pairs)
    handles = [queue.submit(r) for r in reqs]
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    prof = probed = None
    probe_s = 0.0
    if window:
        for _ in range(window):
            engine.step_once()
        prof = idle_window(engine)
        if probe is not None:
            t_probe = time.perf_counter()
            launches = PA.paged_decode_attention.launches
            probed = probe(engine)
            PA.paged_decode_attention.launches = launches
            probe_s = time.perf_counter() - t_probe
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - probe_s
    launches = PA.paged_decode_attention.launches
    if post is not None:
        post.close()
    results = [h.result(timeout=60) for h in handles]
    for r in results:
        check(r.ok, f"request {r.request_id}: {r.status} {r.reason}")
    return {"engine": engine, "results": results, "wall_s": wall,
            "k4_launches": launches, "stats": engine.stats(),
            "counters": engine.counters(), "profile": prof,
            "pair_pages": pairs, "probe": probed}


def token_agreement(a: list, b: list) -> dict:
    """Share of equal image tokens between two runs' results, and each
    request's first diverging position (None where identical)."""
    same = total = 0
    first = []
    for x, y in zip(a, b):
        x, y = list(x.tokens), list(y.tokens)
        same += sum(u == v for u, v in zip(x, y))
        total += len(x)
        diff = [i for i, (u, v) in enumerate(zip(x, y)) if u != v]
        first.append(diff[0] if diff else None)
    return {"identical_share": same / total, "first_divergence": first}


def run_summary(cfg, run: dict) -> dict:
    steps = run["stats"]["decode_steps"]
    image_tokens = sum(len(res.tokens) for res in run["results"])
    st = run["stats"]
    out = {"wall_s": run["wall_s"], "decode_steps": steps,
           "ms_per_decode_step": run["wall_s"] * 1e3 / steps,
           "image_tokens_per_s": image_tokens / run["wall_s"],
           "k4_launches": run["k4_launches"], "profile": run["profile"],
           "counters": run["counters"]}
    for key in ("pages_peak", "evicted", "prefix_hits", "prefill_p50_ms",
                "warm_admit_p50_ms", "spec_acceptance_rate",
                "spec_tokens_per_round", "spec_rounds"):
        if key in st:
            out[key] = st[key]
    prof = run["profile"]
    if prof and isinstance(prof.get("device_ms_per_step"), float):
        # against the run's own wall a step: the profiled window's wall
        # carries the profiler's host cost
        out["device_idle_share"] = max(
            0.0, 1 - prof["device_ms_per_step"] / out["ms_per_decode_step"])
    if "prefill_p50_ms" in st:
        out["prefill_ms_saved_by_warm_admission"] = \
            st["prefill_p50_ms"] - st["warm_admit_p50_ms"]
    pairs = run["pair_pages"]
    guided = [own for pair, _, own in pairs if pair]
    plain = [own for pair, _, own in pairs if not pair]
    if guided and plain:
        out["pair_pages_over_unguided"] = (sum(guided) / len(guided)) / (
            sum(plain) / len(plain))
    return out


def check_feature_run(cfg, name: str, run: dict, reqs) -> None:
    """Every result ok, its grid's ids (``image_seq_len``, or the
    request's override) in range, every page back except what the prefix
    index holds, and the index's ``clear()`` returns those."""
    for r, res in zip(reqs, run["results"]):
        toks = torch.as_tensor(res.tokens)
        grid = r.image_seq_len_override or cfg.image_seq_len
        check(toks.shape == (grid,) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.num_image_tokens,
              f"{name}: request {res.request_id}: bad image tokens")
        check(list(res.text_tokens[:len(r.codes)]) == list(r.codes),
              f"{name}: request {res.request_id}: text lost its prompt")
    engine = run["engine"]
    if engine.kv != "paged":
        return
    held = engine.prefix.pages_held if engine.prefix is not None else 0
    check(engine.alloc.in_use == held, f"{name}: {engine.alloc.in_use} "
          f"pages in use, the index holds {held}: pages leaked")
    if engine.prefix is not None:
        engine.prefix.clear()
        check(engine.alloc.in_use == 0, f"{name}: the index's clear() left "
              f"{engine.alloc.in_use} pages")


def spec_k4_case(engine, dtype=torch.bfloat16, offset: int = 2) -> dict:
    """K4 as the verify launches it, on the run's live state: the pool's
    layer 0, the block tables and chunk-start positions of the engine
    mid-run, the row mask of offset ``offset`` (``_chunk_masks``), random
    queries; held against the plain version with the ``kernel`` phase's
    bfloat16 tolerances, timed beside it and the byte bound."""
    from dalle_pytorch_tpu_torch.ops import decode as decode_ops
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    cfg = engine.cfg.transformer
    pool = engine.pool
    kp, vp = pool["k"][0], pool["v"][0]
    pos = engine.pos.clone()
    bt = engine.block_tables
    allowed = decode_ops._chunk_masks(cfg, pos, engine.key_mask,
                                      SPEC_K)[0][:, offset].contiguous()
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((pos.numel(), cfg.heads, cfg.dim_head), generator=g,
                    device="cuda").to(dtype)
    args = (q, kp, vp, bt, pos, allowed)
    scale = cfg.scale
    got = PA.paged_decode_attention(*args, scale=scale)
    want = PA.paged_decode_attention_plain(*args, scale=scale)
    mag = PA.paged_decode_attention_plain(q, kp, vp.abs(), bt, pos, allowed,
                                          scale=scale)[0]
    err = partials_held("spec K4", got, want, mag, 1e-2, 1e-2)
    ms = cuda_ms(lambda: PA.paged_decode_attention(*args, scale=scale),
                 iters=50)
    plain_ms = cuda_ms(lambda: PA.paged_decode_attention_plain(
        *args, scale=scale), iters=10, warmup=2)
    bound, by = bound_ms(q, kp, pos, None)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by,
            "positions": [int(p) for p in pos.tolist()]}


def phase_serve_features() -> dict:
    """The single engine's serving features at the north width (bfloat16,
    depth ``SERVE_DEPTH``, seeded weights; 8 slots, K = 8, page 16) on
    ``feature_requests``:

    A. ``kv='paged'``, ``paged_attn='kernel'``, ``prefix_cache=True``, the
       pool cut to ``FEATURE_PAGES`` so that eviction fires, with the
       postprocess worker scoring every image through a seeded
       ``CLIPConfig()`` CLIP (K3 without the causal constraint, 12
       launches an image): every handle completes, evicted >= 1,
       prefix_hits >= 2, cfg_pairs == 2, no page leaks and the index's
       clear() returns every page it held, K4 launched depth x decode
       steps; each score equals a synchronous ``clip_apply`` of the same
       image and caption to rtol/atol 1e-2 (bfloat16: a few roundings of
       2^-8 relative on scores bounded by exp(1)); an injected failure
       comes back as ``status='error'``;
    B. the same with ``speculative=4``, ``draft_layers=1``, each request
       capped at ``IDENTITY_GRID`` image tokens: K4 launched
       rounds x (1 x 6 + depth x 4), the acceptance, K4 held against its
       plain version at one verify offset's row mask on the run's state;
    C. ``kv='dense'`` (gather reads, no K4), capped as B.
    A's wall includes the worker's VAE decode and CLIP scoring on the same
    card; its profiled window (after 40 chunks, 320 decode steps) comes
    before any request completes, so that window is the engine's alone.
    Then A, B (1-layer draft) and C again in float32 on
    ``IDENTITY_REQUESTS`` capped at ``IDENTITY_GRID`` image tokens (a
    pool of ``IDENTITY_PAGES``), whose tokens must be identical; the
    phase's seconds run by run are in ``seconds``; the float32 A alone times its admissions
    (cold prefill against warm admission), so no bfloat16 wall carries
    their synchronisations; at bfloat16 the share of identical
    tokens and the first diverging positions of B and C against A are
    printed, not checked."""
    import dataclasses
    from dalle_pytorch_tpu_torch.models import clip as CL
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.postprocess import PostProcessor
    cfg = dataclasses.replace(north_cfg(), depth=SERVE_DEPTH)
    reqs = feature_requests(cfg)
    seconds = {}
    t_run = time.perf_counter()

    def lap(name):
        # where the phase's seconds go, run by run
        nonlocal t_run
        now = time.perf_counter()
        seconds[name] = now - t_run
        t_run = now
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    clip = CL.clip_init(CL.CLIPConfig(sparse_impl="pallas"), seed=7,
                        dtype=torch.bfloat16)
    record = dict(phase="serve_features", ok=True, requests=len(reqs),
                  num_pages=FEATURE_PAGES, depth=cfg.depth)

    # A: the eager engine with the prefix cache, eviction and the worker
    post = PostProcessor(vae, model, clip=clip).start()
    BS.block_sparse_attention_fwd.launches = 0
    a = feature_run(model, reqs, window=40, post=post, **FEATURE_ENGINE)
    k3 = BS.block_sparse_attention_fwd.launches
    check_feature_run(cfg, "A", a, reqs)
    st = a["stats"]
    check(st["evicted"] >= 1, f"A: no eviction ({st['evicted']})")
    check(st["prefix_hits"] >= 2, f"A: {st['prefix_hits']} prefix hits")
    check(st["cfg_pairs"] == 2, f"A: cfg_pairs {st['cfg_pairs']}, not 2")
    check(a["k4_launches"] == cfg.depth * st["decode_steps"],
          f"A: K4 launched {a['k4_launches']} times, not depth x "
          f"{st['decode_steps']} decode steps")
    check(k3 == 12 * len(reqs), f"A: K3 launched {k3} times for "
          f"{len(reqs)} CLIP scores, not 12 each")
    score_err = 0.0
    with torch.no_grad():
        for res in a["results"]:
            check(res.clip_score is not None and math.isfinite(res.clip_score)
                  and res.image.shape == (256, 256, 3),
                  f"A: request {res.request_id} has no image or score")
            img = torch.as_tensor(res.image, device="cuda")
            text = torch.as_tensor(res.text_tokens, device="cuda").long()
            want = float(CL.clip_apply(clip, text[None],
                                       img.to(torch.bfloat16)[None])[0])
            score_err = max(score_err, abs(res.clip_score - want))
            check(abs(res.clip_score - want) <= 1e-2 + 1e-2 * abs(want),
                  f"A: worker score {res.clip_score} != clip_apply {want}")
    post = PostProcessor(vae, model, clip=clip).start()
    bad = S.RequestHandle(reqs[0])
    post.submit(bad, S.Result(status=S.OK, request_id=99, tokens=None))
    post.close()
    check(bad.result(timeout=30).status == S.ERROR,
          "an injected postprocess failure did not come back as an error")
    record["A"] = run_summary(cfg, a)
    record["A"].update(k3_launches=k3, clip_score_max_abs_err=score_err,
                       clip_scores=[r.clip_score for r in a["results"]])
    lap("A")

    # B: speculation through K4, one walk per draft and verify offset, on
    # the requests capped at ``IDENTITY_GRID`` image tokens (B and C: their
    # steps are host-bound, and the whole grid cost the smoke 120-160 s)
    breqs = [dataclasses.replace(r, image_seq_len_override=IDENTITY_GRID)
             for r in reqs]
    b = feature_run(model, breqs, window=20, probe=spec_k4_case,
                    speculative=SPEC_K, draft_layers=SPEC_DRAFT,
                    **FEATURE_ENGINE)
    check_feature_run(cfg, "B", b, breqs)
    rounds = b["stats"]["decode_steps"]
    per_round = SPEC_DRAFT * SPEC_K * (SPEC_K - 1) // 2 + cfg.depth * SPEC_K
    check(b["k4_launches"] == rounds * per_round,
          f"B: K4 launched {b['k4_launches']} times, not {rounds} rounds x "
          f"{per_round}")
    record["B"] = run_summary(cfg, b)
    record["B"].update(k4_launches_per_round=per_round,
                       k4_at_verify_offset=b["probe"])
    record["B_vs_A"] = token_agreement(b["results"], a["results"])
    lap("B")

    # C: the dense slot cache through the gather read, on B's requests
    c = feature_run(model, breqs, window=20, num_slots=8, chunk_steps=8,
                    kv="dense")
    check_feature_run(cfg, "C", c, breqs)
    check(c["k4_launches"] == 0, "C: the dense engine launched K4")
    record["C"] = run_summary(cfg, c)
    record["C_vs_A"] = token_agreement(c["results"], a["results"])
    lap("C")

    # float32: tokens identical across A, B and C
    del model, a, b, c
    fcfg = dataclasses.replace(cfg, depth=IDENTITY_DEPTH)
    fvae = V.vae_init(fcfg.vae, seed=3)
    fmodel = D.dalle_init(fcfg, seed=4, vae=fvae)
    freqs = [dataclasses.replace(reqs[i], image_seq_len_override=IDENTITY_GRID)
             for i in IDENTITY_REQUESTS]
    fengine = {**FEATURE_ENGINE, "num_pages": IDENTITY_PAGES}
    fa = feature_run(fmodel, freqs, time_admissions=True, **fengine)
    lap("float32_A")
    fb = feature_run(fmodel, freqs, speculative=SPEC_K,
                     draft_layers=IDENTITY_DRAFT, **fengine)
    lap("float32_B")
    fc = feature_run(fmodel, freqs, num_slots=8, chunk_steps=8, kv="dense")
    lap("float32_C")
    ident = {}
    for name, run in (("B", fb), ("C", fc)):
        agree = token_agreement(run["results"], fa["results"])
        ident[name] = agree
        check(agree["identical_share"] == 1.0,
              f"float32 depth {IDENTITY_DEPTH}: {name}'s tokens differ from "
              f"A's: {agree}")
    record["seconds"] = seconds
    record["float32_identity"] = {
        "depth": IDENTITY_DEPTH, "draft_layers": IDENTITY_DRAFT,
        "requests": len(freqs), "grid": IDENTITY_GRID,
        "num_pages": IDENTITY_PAGES,
        "evicted": fa["stats"]["evicted"],
        "prefill_p50_ms": fa["stats"]["prefill_p50_ms"],
        "warm_admit_p50_ms": fa["stats"]["warm_admit_p50_ms"],
        "prefill_ms_saved_by_warm_admission":
            fa["stats"]["prefill_p50_ms"] - fa["stats"]["warm_admit_p50_ms"],
        "spec_tokens_per_round": fb["stats"]["spec_tokens_per_round"],
        "wall_s": {"A": fa["wall_s"], "B": fb["wall_s"], "C": fc["wall_s"]},
        **ident}
    emit(**record)
    return record


def reference_state_dict(cfg, seed: int = 11) -> dict:
    """A reference-layout DALLE ``state_dict`` (the reference's key names
    and torch layouts: ``transformer.layers.layers.{i}.{0,1}``, the
    summed axial table over (image_size, image_size), the embedded VAE
    with its codebook tied to ``image_emb``) at ``cfg``'s widths, float32,
    seeded."""
    g = torch.Generator().manual_seed(seed)

    def w(*shape, std=0.02):
        return torch.randn(shape, generator=g) * std

    d, inner, v = cfg.dim, cfg.heads * cfg.dim_head, cfg.vae
    sd = {"vae.codebook.weight": w(v.num_tokens, v.codebook_dim, std=1.0)}
    ch = [v.channels] + [v.hidden_dim] * v.num_layers
    for i in range(v.num_layers):
        sd[f"vae.encoder.{i}.0.weight"] = w(ch[i + 1], ch[i], 4, 4)
        sd[f"vae.encoder.{i}.0.bias"] = w(ch[i + 1])
    sd[f"vae.encoder.{v.num_layers}.weight"] = w(v.num_tokens, ch[-1], 1, 1)
    sd[f"vae.encoder.{v.num_layers}.bias"] = w(v.num_tokens)
    dec = [v.codebook_dim] + [v.hidden_dim] * v.num_layers
    for i in range(v.num_layers):
        sd[f"vae.decoder.{i}.0.weight"] = w(dec[i], dec[i + 1], 4, 4)
        sd[f"vae.decoder.{i}.0.bias"] = w(dec[i + 1])
    sd[f"vae.decoder.{v.num_layers}.weight"] = w(v.channels, dec[-1], 1, 1)
    sd[f"vae.decoder.{v.num_layers}.bias"] = w(v.channels)
    for i in range(cfg.depth):
        a, f = f"transformer.layers.layers.{i}.0.", \
            f"transformer.layers.layers.{i}.1."
        sd.update({a + "norm.weight": 1 + w(d), a + "norm.bias": w(d),
                   a + "fn.to_qkv.weight": w(3 * inner, d),
                   a + "fn.to_out.0.weight": w(d, inner),
                   a + "fn.to_out.0.bias": w(d),
                   f + "norm.weight": 1 + w(d), f + "norm.bias": w(d),
                   f + "fn.net.0.weight": w(8 * d, d),
                   f + "fn.net.0.bias": w(8 * d),
                   f + "fn.net.3.weight": w(d, 4 * d),
                   f + "fn.net.3.bias": w(d)})
    size = v.image_size
    sd.update({"text_emb.weight": w(cfg.num_text_tokens, d, std=1.0),
               "image_emb.weight": sd["vae.codebook.weight"],
               "text_pos_emb.weight": w(cfg.text_seq_len, d, std=1.0),
               "image_pos_emb.weights.0": w(1, size, 1, d, std=1.0),
               "image_pos_emb.weights.1": w(1, 1, size, d, std=1.0),
               "to_logits.0.weight": 1 + w(d), "to_logits.0.bias": w(d),
               "to_logits.1.weight": w(cfg.total_tokens, d),
               "to_logits.1.bias": w(cfg.total_tokens)})
    return sd


def phase_import() -> dict:
    """Reference weights in and out through the entry points' ``main``:
    a seeded reference-layout DALLE ``state_dict`` at the north width
    (depth ``SERVE_DEPTH``) is
    saved as a ``.pth``; ``import_torch dalle`` turns it into a DALLE and
    a VAE checkpoint; ``gen_dalle`` samples one image from them on the
    card (its grid PNG 260 x 260 x 3); ``export-dalle`` writes the
    checkpoint back, and every tensor must equal the input bit for bit.
    The JAX package's import CLI records no ``meta.vae_checkpoint``, which
    gen_dalle and export-dalle read, so the manifest gains it here, as a
    user would add it."""
    import dataclasses
    import shutil
    import tempfile
    from dalle_pytorch_tpu_torch import checkpoint as C
    from dalle_pytorch_tpu_torch.cli import gen_dalle, import_torch
    from dalle_pytorch_tpu_torch.data import images as I
    cfg = dataclasses.replace(north_cfg(), depth=SERVE_DEPTH)
    root = tempfile.mkdtemp(prefix="chip-smoke-import-")
    try:
        sd = reference_state_dict(cfg)
        pth = os.path.join(root, "dalle.pth")
        torch.save(sd, pth)
        models = os.path.join(root, "models")
        dalle_dir = os.path.join(models, "imported_dalle-0")
        vae_dir = os.path.join(models, "imported_vae-0")
        t0 = time.perf_counter()
        import_torch.main(["dalle", pth, "--out", dalle_dir, "--vae_out",
                           vae_dir, "--heads", str(cfg.heads)])
        import_s = time.perf_counter() - t0
        manifest = C.load_manifest(dalle_dir)
        manifest["meta"]["vae_checkpoint"] = vae_dir
        with open(os.path.join(dalle_dir, C.MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        with open(os.path.join(root, "only.txt"), "w") as f:
            f.write("a red square\na small blue circle\n")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_dalle.main(["a red square", "--name", "imported",
                        "--dalle_epoch", "0", "--num_images", "1",
                        "--seed", "5", "--models_dir", models,
                        "--results_dir", os.path.join(root, "gen"),
                        "--captions_only", os.path.join(root, "only.txt")])
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        (png,) = os.listdir(os.path.join(root, "gen"))
        img = I.read_image(os.path.join(root, "gen", png))
        check(img.shape == (260, 260, 3), f"import: the grid is {img.shape}")
        back = os.path.join(root, "back.pth")
        t0 = time.perf_counter()
        import_torch.main(["export-dalle", back, "--out", dalle_dir])
        export_s = time.perf_counter() - t0
        out = torch.load(back, weights_only=True)
        check(set(out) == set(sd), f"import: export keys differ: "
              f"{sorted(set(out) ^ set(sd))[:8]}")
        unequal = [k for k in sd if not torch.equal(out[k], sd[k])]
        check(not unequal, f"import: {len(unequal)} tensors changed, e.g. "
                           f"{unequal[:4]}")
        record = dict(phase="import", ok=True, tensors=len(sd),
                      pth_bytes=os.path.getsize(pth), import_s=import_s,
                      gen_dalle_s=gen_s, export_s=export_s,
                      round_trip_bit_equal=True,
                      gen_grid_shape=list(img.shape))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(**record)
    return record


# -- the HTTP server ----------------------------------------------------------

HTTP_SERVER = dict(num_slots=8, chunk_steps=8, kv="paged", page_size=16,
                   paged_attn="kernel", prefix_cache=True, preview_every=32)
HTTP_PROMPT_LEN = 17
HTTP_SHORT_GRID = 256
HTTP_TOKEN = "smoke-admin"


class HttpClient:
    """Blocking calls to the server on ``127.0.0.1:port``."""

    def __init__(self, port: int):
        self.port = port

    def _conn(self, method, path, body, token):
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=600)
        headers = {"Content-Type": "application/json"}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        data = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode())
        conn.request(method, path, body=data, headers=headers)
        return conn

    def call(self, method, path, body=None, token=None):
        """(status, raw body bytes)."""
        conn = self._conn(method, path, body, token)
        resp = conn.getresponse()
        raw = resp.read()
        conn.close()
        return resp.status, raw

    def json(self, method, path, body=None, token=None):
        code, raw = self.call(method, path, body, token)
        return code, json.loads(raw)

    def sse(self, body, t0: float, first=None, tear_after: int = 0):
        """POST a streamed request and read its events to the end, or,
        with ``tear_after``, tear the connection (an RST) after that many
        token events. Returns (events, seconds to the first token event);
        ``first`` (an Event) is set at the first token event."""
        import socket
        import struct
        conn = self._conn("POST", "/generate", body, None)
        sock = conn.sock
        resp = conn.getresponse()
        check(resp.status == 200, f"http: stream answered {resp.status}")
        events, kind, first_s, n_tok = [], None, None, 0
        while True:
            line = resp.fp.readline()
            if not line:
                break
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                kind = line[len("event: "):]
            elif line.startswith("data: "):
                events.append({"event": kind,
                               **json.loads(line[len("data: "):])})
                if kind != "tokens":
                    continue
                n_tok += 1
                if first_s is None:
                    first_s = time.perf_counter() - t0
                    if first is not None:
                        first.set()
                if tear_after and n_tok >= tear_after:
                    # linger 0: the close resets the connection
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                    struct.pack("ii", 1, 0))
                    resp.close()
                    sock.close()
                    return events, first_s
        resp.close()
        return events, first_s


def wait_for(what: str, cond, timeout_s: float = 120.0, every=0.05):
    """Poll ``cond()`` until it is true, at most ``timeout_s``."""
    deadline = time.perf_counter() + timeout_s
    while not cond():
        check(time.perf_counter() < deadline,
              f"http: {what} not seen in {timeout_s:g} s")
        time.sleep(every)


def phase_http() -> dict:
    """The port's ``InferenceServer`` over HTTP at the north width
    (bfloat16, depth ``SERVE_DEPTH``, seeded weights, ``serve_features``'
    CLIP scoring every image through K3): 8 slots, K = 8, page 16, the
    kernel read
    (K4), the prefix cache, a preview every 32 chunks, served by
    ``make_http_server`` on 127.0.0.1 in a thread. Six client threads send
    at once, with one 17-token prompt and one seed, filling the 8 slots in
    one wave: A plain; B a stream; C ``n_samples=2``; D
    ``image_seq_len_override=256``; E a stream the client tears (an RST)
    after 3 token events; F ``cfg_scale=3.0`` (a slot pair). Mid-decode,
    ``POST /admin/profile {"chunks": 4}`` (then 409 while it runs), and
    the error answers: 400 for an empty and a 257-token prompt, 404, 401
    and 409 ``not_a_replica_set`` from ``/admin/scale``.

    Held: A's 1,024 ids in [0, 2048), its (256, 256, 3) image, finite
    CLIP score and a trace with ``prefill_admit``; B's token events cover
    each position once and end in A's tokens, at least 3 mid-stream
    previews, its final frame the VAE decode of its tokens (to 1e-2, bf16
    pixels; the difference is printed); C ranked by CLIP score, its sample
    0 (the user's seed) A's tokens; D A's first 256; E reaped (``/stats``
    polled), ``serve_slot_reaped`` in ``/debug/events``; F ok; K4
    launched depth x decode steps times, K3 12 times a scored image; the
    profile's trace naming K4's body; then ``/healthz`` 200, no stream or
    group in flight, one group completed, every page free but the prefix
    cache's, ``/metrics``' e2e count the delivered results, and
    ``close()`` joining the engine thread. Printed: e2e and queue-wait
    percentiles, the client's seconds to B's first token, ms a decode step
    and image tokens a second under the server (the wave's wall over its
    steps), preview frames and drops."""
    import dataclasses
    import glob
    import shutil
    import tempfile
    import threading
    from dalle_pytorch_tpu_torch.models import clip as CL
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve import stream as ST
    from dalle_pytorch_tpu_torch.serve.server import (InferenceServer,
                                                      make_http_server)
    cfg = dataclasses.replace(north_cfg(), depth=SERVE_DEPTH)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    clip = CL.clip_init(CL.CLIPConfig(sparse_impl="pallas"), seed=7,
                        dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(15)
    prompt = [int(t) for t in torch.randint(1, cfg.num_text_tokens,
                                            (HTTP_PROMPT_LEN,),
                                            generator=g)]
    seed = 21
    prof_dir = tempfile.mkdtemp(prefix="chip-smoke-http-profile-")
    srv = InferenceServer(model, vae, clip=clip, admin_token=HTTP_TOKEN,
                          profile_dir=prof_dir, **HTTP_SERVER).start()
    httpd = make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    client = HttpClient(httpd.server_address[1])
    record = dict(phase="http", ok=True, server=HTTP_SERVER,
                  prompt_len=HTTP_PROMPT_LEN, depth=cfg.depth)
    try:
        base = {"codes": prompt, "seed": seed}
        bodies = {"A": base, "C": {**base, "n_samples": 2},
                  "D": {**base, "image_seq_len_override": HTTP_SHORT_GRID},
                  "F": {**base, "cfg_scale": 3.0}}
        out: dict = {}
        errors: list = []
        first = threading.Event()

        def run(name, fn):
            try:
                out[name] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append((name, e))

        torch.cuda.synchronize()
        PA.paged_decode_attention.launches = 0
        BS.block_sparse_attention_fwd.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(
            name, lambda b=body: client.json("POST", "/generate", b)))
            for name, body in bodies.items()]
        threads.append(threading.Thread(target=run, args=(
            "B", lambda: client.sse({**base, "stream": True}, t0, first))))
        threads.append(threading.Thread(target=run, args=(
            "E", lambda: client.sse({**base, "stream": True}, t0,
                                    tear_after=3))))
        for t in threads:
            t.start()
        check(first.wait(600), "http: no token event on the stream")
        prof = client.json("POST", "/admin/profile", {"chunks": 4},
                           token=HTTP_TOKEN)
        again = client.json("POST", "/admin/profile", {"chunks": 1},
                             token=HTTP_TOKEN)
        answers = {
            "empty_prompt": client.json("POST", "/generate", {"codes": []}),
            "prompt_257": client.json(
                "POST", "/generate",
                {"codes": [1] * (cfg.text_seq_len + 1)}),
            "get_nope": client.json("GET", "/nope"),
            "scale_no_token": client.json("POST", "/admin/scale",
                                          {"op": "status"}),
            "scale_token": client.json("POST", "/admin/scale",
                                       {"op": "status"}, token=HTTP_TOKEN)}
        wait_for("the torn stream's reap",
                 lambda: client.json("GET", "/stats")[1]["reaped"] >= 1)
        debug = client.json("GET", "/debug/events")[1]["server"]
        check(any(e.get("kind") == "serve_slot_reaped" for e in debug),
              "http: no serve_slot_reaped in /debug/events")
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        check(not errors, f"http: client failures {errors}")
        check(all(not t.is_alive() for t in threads),
              "http: a client thread did not finish")
        wait_for("the profile's end", lambda: not client.json(
            "GET", "/stats")[1]["profile_active"])
        k4 = PA.paged_decode_attention.launches
        k3 = BS.block_sparse_attention_fwd.launches
        stats = client.json("GET", "/stats")[1]
        code, metrics = client.call("GET", "/metrics")
        health = client.json("GET", "/healthz")

        # the answers
        expect = {"empty_prompt": 400, "prompt_257": 400, "get_nope": 404,
                  "scale_no_token": 401, "scale_token": 409}
        for name, (code_, body) in answers.items():
            check(code_ == expect[name], f"http: {name} answered {code_} "
                  f"{body}, not {expect[name]}")
        check(answers["prompt_257"][1]["reason"] == "invalid_prompt"
              and answers["scale_token"][1]["reason"]
              == "not_a_replica_set", f"http: bodies {answers}")
        check(prof[0] == 200 and prof[1]["kind"] == "serve_profile_armed",
              f"http: /admin/profile answered {prof}")
        check(again[0] == 409 and again[1]["reason"] == "capture_active",
              f"http: a second capture answered {again}")

        # the results
        code_a, a = out["A"]
        check(code_a == 200 and a["status"] == "ok", f"http: A {a}")
        toks = a["tokens"]
        check(len(toks) == cfg.image_seq_len and min(toks) >= 0
              and max(toks) < cfg.num_image_tokens,
              "http: A's image tokens")
        size = cfg.vae.image_size
        check(a["image_shape"] == [size, size, 3]
              and math.isfinite(a["clip_score"]),
              f"http: A's image {a.get('image_shape')} or score")
        check("prefill_admit" in [s["name"] for s in a["trace"]["spans"]],
              "http: A's trace has no prefill_admit span")
        events, first_s = out["B"]
        pos = HTTP_PROMPT_LEN
        streamed = []
        for ev in events:
            if ev["event"] == "tokens":
                check(ev["pos"] == pos, f"http: B's event at {ev['pos']}, "
                      f"not {pos}")
                pos += len(ev["tokens"])
                streamed += ev["tokens"]
        check(pos == cfg.seq_len, f"http: B's events end at {pos}")
        check(streamed[-cfg.image_seq_len:] == toks,
              "http: B's streamed tokens differ from A's")
        frames = [e for e in events if e["event"] == "preview"]
        mid = [f for f in frames if not f["final"]]
        check(len(mid) >= 3 and frames[-1]["final"],
              f"http: B got {len(mid)} mid-stream previews")
        b_res = events[-1]
        check(b_res["event"] == "result" and b_res["tokens"] == toks,
              "http: B's result frame")
        with torch.no_grad():
            want = srv.post.decode(b_res["tokens"]).float().cpu().numpy()
        got = ST.unpack_image(frames[-1]["image"])
        frame_err = float(abs(got - want).max())
        check(frame_err <= 1e-2, f"http: B's final frame is {frame_err} "
              f"from the VAE decode of its tokens")
        code_c, c = out["C"]
        check(code_c == 200 and c["status"] == "ok" and
              len(c["samples"]) == 2, f"http: C {c.get('status')}")
        scores = [s["clip_score"] for s in c["samples"]]
        check(scores == sorted(scores, reverse=True),
              f"http: C's samples not ranked: {scores}")
        (s0,) = [s for s in c["samples"]
                 if s["request_id"] == c["request_id"]]
        check(s0["tokens"] == toks, "http: C's sample 0 differs from A")
        code_d, d = out["D"]
        check(code_d == 200 and d["tokens"] == toks[:HTTP_SHORT_GRID],
              "http: D's tokens are not A's first 256")
        code_f, f = out["F"]
        check(code_f == 200 and f["status"] == "ok"
              and len(f["tokens"]) == cfg.image_seq_len, "http: F")
        e_events, _ = out["E"]
        check(sum(e["event"] == "tokens" for e in e_events) == 3,
              "http: E was not torn after 3 token events")

        # the path went through the kernels
        steps = stats["decode_steps"]
        check(k4 == cfg.depth * steps, f"http: K4 launched {k4} times, "
              f"not depth x {steps} decode steps")
        scored = 6          # A, B, C's two, D, F (E was reaped)
        per_score = clip.cfg.text_enc_depth + clip.cfg.visual_enc_depth
        check(k3 == per_score * scored, f"http: K3 launched {k3} times "
              f"for {scored} CLIP scores, not {per_score} each")
        (trace,) = glob.glob(os.path.join(prof_dir, "trace-steps*.json"))
        with open(trace) as fh:
            names = {e.get("name", "") for e in json.load(fh).get(
                "traceEvents", []) if e.get("cat") == "kernel"}
        body = PA.kernel_body(torch.bfloat16, cfg.dim_head)
        check(any(body in n for n in names),
              f"http: the /admin/profile trace names no {body}")

        # afterwards
        check(health == (200, {"ok": True, "devices_per_replica": 1,
                               "mesh_shape": None}),
              f"http: /healthz {health}")
        check(stats["streams_active"] == 0
              and stats["groups_in_flight"] == 0
              and stats["groups_completed"] == 1 and stats["reaped"] >= 1,
              f"http: stats {stats}")
        check(stats["pages_in_use"] == stats["prefix_pages_held"],
              f"http: {stats['pages_in_use']} pages in use, the prefix "
              f"cache holds {stats['prefix_pages_held']}")
        count = sum(int(ln.split()[-1]) for ln in metrics.decode()
                    .splitlines() if ln.startswith(
                        "dalle_serve_e2e_latency_seconds_count"))
        check(code == 200 and count == scored,
              f"http: /metrics counts {count} delivered, not {scored}")
        image_tokens = cfg.image_seq_len * 5 + HTTP_SHORT_GRID
        record.update(
            wall_s=wall, decode_steps=steps,
            ms_per_decode_step=wall * 1e3 / steps,
            image_tokens_per_s=image_tokens / wall,
            first_token_s=first_s,
            latency_ms=stats["latency_ms"],
            p50_latency_s=stats["p50_latency_s"],
            p95_latency_s=stats["p95_latency_s"],
            preview_frames=stats["preview_frames"],
            preview_drops=stats["preview_drops"],
            previews_requested=stats["previews_requested"],
            mid_stream_previews=len(mid), final_frame_max_abs_err=frame_err,
            k4_launches=k4, k3_launches=k3, reaped=stats["reaped"],
            prefix_hits=stats["prefix_hits"], cfg_pairs=stats["cfg_pairs"],
            pages_peak=stats["pages_peak"],
            clip_scores={"A": a["clip_score"], "C": scores,
                         "D": d["clip_score"], "F": f["clip_score"]},
            profile_kernels=len(names),
            answers={k: v[0] for k, v in answers.items()})
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
        shutil.rmtree(prof_dir, ignore_errors=True)
    check(not srv._thread.is_alive(), "http: close() left the engine "
          "thread running")
    emit(**record)
    return record

# -- the serving mesh ----------------------------------------------------------

# the mesh phase's engines: 8 slots, K = 8, page 16; its requests capped
# at MESH_GRID image tokens (serve_features B and C's grid), the bfloat16
# timing runs at MESH_TIMED_GRID
MESH_ENGINE = dict(num_slots=8, chunk_steps=8, page_size=16)
MESH_GRID = 256
MESH_TIMED_GRID = 64
# the runs over cuda:0 and the CPU: 17 text steps and 32 image tokens
MESH_SPLIT_GRID = 32
MESH_DEVICES = 2
# the most a decode step may join onto devices[0] at the north width,
# depth 12, 8 slots, two shards: the other shard's layers (100,835,328
# bytes in f32) and a few hundred KB of attention outputs, logits'
# columns and table rows
MESH_NORTH_JOIN_LIMITS = {"float32": 102_000_000, "bfloat16": 51_000_000}


def mesh_requests(cfg, grid: int, n: int = 4, seed: int = 40,
                  short: int = 48) -> list:
    """``n`` requests (prompts of ``text_seq_len`` less ``short``, 17 and
    0 tokens, so that every run decodes text positions and its steps
    stay few; top-k, top-p 0.9 and greedy, one guided pair) capped at
    ``grid`` image tokens."""
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    g = torch.Generator().manual_seed(seed)
    t = cfg.text_seq_len
    lens = (max(t - short, 1), t - 17, t, t - 17)
    samplings = (S.SamplingParams(), S.SamplingParams(top_p=0.9),
                 S.SamplingParams(filter_thres=1.0), S.SamplingParams())
    return [S.Request(tuple(int(t) for t in torch.randint(
        1, cfg.num_text_tokens, (lens[i % 4],), generator=g)),
        seed=seed + i, sampling=samplings[i % 4],
        cfg_scale=3.0 if i % 4 == 3 else 0.0,
        image_seq_len_override=grid) for i in range(n)]


def mesh_run(model, reqs, devices=None, **kw) -> dict:
    """One engine (a ``MeshEngine`` over ``devices``, else the single
    ``Engine`` on the card) over ``reqs`` to the end: tokens, wall,
    decode steps, stats and the engine."""
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.mesh_engine import MeshEngine
    queue = S.RequestQueue(max_prompt_len=model.cfg.text_seq_len)
    engine = (MeshEngine(model, queue, devices=devices, **kw)
              if devices is not None
              else Engine(model, queue, device="cuda", **kw))
    handles = [queue.submit(r) for r in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = []
    for h in handles:
        res = h.result(timeout=0)
        check(res.ok, f"mesh: request {res.request_id}: {res.status} "
                      f"{res.reason}")
        toks.append([int(t) for t in res.tokens])
    return {"tokens": toks, "wall_s": wall, "engine": engine,
            "decode_steps": engine.decode_steps, "stats": engine.stats()}


def mesh_join_per_step(model, devices, reqs, **kw) -> dict:
    """A ``MeshEngine`` over ``devices`` with ``reqs`` admitted and
    decoding: the bytes its join counted a decode step over one chunk
    with no admission, beside ``step_join_bytes()`` and its terms."""
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.mesh_engine import MeshEngine
    queue = S.RequestQueue(max_prompt_len=model.cfg.text_seq_len)
    engine = MeshEngine(model, queue, devices=devices, **kw)
    for r in reqs:
        queue.submit(r)
    engine.step_once()
    check(engine.active_slots() > 0 and queue.depth() == 0,
          "mesh: the join count's requests were not all admitted")
    moved, steps = engine.stats()["join_bytes"], engine.decode_steps
    engine.step_once()
    torch.cuda.synchronize()
    per_step = ((engine.stats()["join_bytes"] - moved)
                / (engine.decode_steps - steps))
    return {"per_step": per_step, "reckoned": engine.step_join_bytes(),
            "terms": engine.step_join_terms(),
            "shard1_kv_on_cpu": all(
                b.is_cpu for b in engine.pool.parts[1].values())}


def head_split_bits() -> dict:
    """Whether a product over half the heads gives the whole product's
    bits, at the decode read's shape (8 slots, 8 heads, one query, 1,280
    cached rows, dh 64, float32) on the card and on the CPU: the mesh
    attends per head shard (``ops/decode.py::_read_layer``), so its
    attention outputs may differ from the single engine's by this much,
    and its tokens are held to the single engine's."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(8, 8, 1, 64, generator=g)
    k = torch.randn(8, 8, 1280, 64, generator=g)
    out = {}
    for dev in ("cuda", "cpu"):
        qd, kd = q.to(dev), k.to(dev)
        whole = torch.einsum("bhqd,bhjd->bhqj", qd, kd)
        halves = torch.cat([torch.einsum("bhqd,bhjd->bhqj", qd[:, s], kd[:, s])
                            for s in (slice(0, 4), slice(4, 8))], dim=1)
        out[dev] = {"bit_equal": bool(torch.equal(whole, halves)),
                    "max_abs_diff": float((whole - halves).abs().max())}
    return out


def phase_mesh() -> dict:
    """The serving mesh (``serve/mesh_engine.py``) at the north width and
    ``SERVE_DEPTH`` over ``MESH_DEVICES`` entries of ``cuda:0`` (the
    machine has one card: ``serve_specs.visible_devices`` is substituted
    where the server and the replica set list devices):

    * float32, ``mesh_requests`` capped at ``MESH_GRID``: the mesh's
      tokens equal the single engine's, dense, paged (the gather read)
      and paged with int8 KV; K4 never launched;
    * the paged pool's bytes a shard equal the reckoning from its shapes
      (pages x 16 rows x 4 heads x 64 x K and V x depth x 4 bytes), half
      the pool's; the weights a shard lie between half and all; the
      bytes a decode step joins: counted over a chunk with no admission
      and equal to ``step_join_bytes()`` (dense, paged, int8, here and
      over ``[cuda:0, cpu]``), and reckoned at the north depth (meshes
      built on the CPU: shapes only), within the limits below and with
      an attention term that does not grow with ``total_len`` (each
      shard attends over its own heads; only the attention outputs, the
      logits' columns and the looked-up table rows are joined);
    * a mesh built from a host copy adds to the card the whole model
      once (its held tensors) over what the single engine adds, in the
      bytes asked of the allocator (within 1 MiB);
    * float32 over ``[cuda:0, cpu]`` (two distinct devices: every
      cross-device fetch, join and write; shard 1 attends on the CPU
      over its K/V there): dense, paged and int8 tokens equal the single
      engine's, at ``MESH_SPLIT_GRID``, ms a step recorded;
    * ``paged_attn='kernel'`` raises ``MeshPagedAttnError``;
    * ``InferenceServer(mesh_devices=2)`` in bfloat16 with CLIP answers
      2 requests; ``/healthz`` carries ``mesh_shape {"mp": 2}``; its
      postprocess worker launches K3 (counted from 0);
    * a thread ``ReplicaSet`` of two mesh slices over four entries of
      ``cuda:0``, float32: slice 1 crashes at chunk 2, its requests
      replay on slice 0 with the single engine's tokens;
    * bfloat16 ms a decode step, mesh against single, twice each
      alternating (recorded, not checked); and ``head_split_bits``."""
    import dataclasses
    import gc
    from dalle_pytorch_tpu_torch.models import clip as CL
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.parallel import serve_specs as SS
    from dalle_pytorch_tpu_torch.resilience import faults
    from dalle_pytorch_tpu_torch.resilience.retry import RetryPolicy
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.mesh_engine import (
        MeshEngine, MeshPagedAttnError, hbm_report)
    from dalle_pytorch_tpu_torch.serve.replica import ReplicaSet
    from dalle_pytorch_tpu_torch.serve.server import InferenceServer
    cfg = dataclasses.replace(north_cfg(), depth=SERVE_DEPTH)
    devices = [torch.device("cuda", 0)] * MESH_DEVICES
    listed = SS.visible_devices
    record = dict(phase="mesh", ok=True, depth=cfg.depth,
                  devices=[str(d) for d in devices], grid=MESH_GRID)
    seconds = {}
    t_run = time.perf_counter()

    def lap(name):
        nonlocal t_run
        now = time.perf_counter()
        seconds[name] = now - t_run
        t_run = now

    try:
        # float32: the mesh's tokens against the single engine's
        vae32 = V.vae_init(cfg.vae, seed=3)
        model32 = D.dalle_init(cfg, seed=4, vae=vae32)
        reqs = mesh_requests(cfg, MESH_GRID)
        PA.paged_decode_attention.launches = 0
        ref = mesh_run(model32, reqs, kv="dense", **MESH_ENGINE)
        lap("single_dense")
        runs = {}
        for name, kw in (("dense", dict(kv="dense")),
                         ("paged", dict(kv="paged")),
                         ("int8", dict(kv="paged", quantize_cache=True))):
            runs[name] = mesh_run(model32, reqs, devices, **kw,
                                  **MESH_ENGINE)
            lap(f"mesh_{name}")
        ref8 = mesh_run(model32, reqs, kv="paged", quantize_cache=True,
                        **MESH_ENGINE)
        lap("single_int8")
        check(PA.paged_decode_attention.launches == 0,
              "mesh: K4 launched on the gather read")
        ident = {}
        for name, run in runs.items():
            want = ref8 if name == "int8" else ref
            agree = token_agreement_lists(run["tokens"], want["tokens"])
            ident[name] = agree
            check(agree["identical_share"] == 1.0,
                  f"mesh: float32 {name} tokens differ from the single "
                  f"engine's: {agree}")
            check(run["engine"].kv_sharded and run["engine"].params_sharded,
                  f"mesh: {name} did not split its store")
        record["float32_identity"] = ident
        paged = runs["paged"]["engine"]
        st = paged.stats()
        tcfg = cfg.transformer
        reckoned = (paged.num_pages * paged.page_size
                    * (tcfg.heads // MESH_DEVICES) * tcfg.dim_head
                    * 2 * tcfg.depth * 4)
        check(st["kv_hbm_bytes_per_shard"] == reckoned
              and 2 * reckoned == st["kv_hbm_bytes"],
              f"mesh: {st['kv_hbm_bytes_per_shard']} KV bytes a shard of "
              f"{st['kv_hbm_bytes']}, reckoned {reckoned}")
        rep = hbm_report(paged)
        check(rep["param_bytes"] / 2 < rep["param_bytes_per_shard"]
              < rep["param_bytes"], f"mesh: weights a shard {rep}")
        check(st["mesh_shape"] == {"mp": MESH_DEVICES}
              and st["devices_per_replica"] == MESH_DEVICES,
              f"mesh: stats {st['mesh_shape']}")
        record.update(num_pages=paged.num_pages, kv_bytes_reckoned=reckoned,
                      hbm=rep, mesh_decode_steps=runs["paged"]["decode_steps"],
                      step_join_bytes={n: r["engine"].step_join_bytes()
                                       for n, r in runs.items()},
                      join_bytes={n: r["stats"]["join_bytes"]
                                  for n, r in runs.items()})
        lap("surface")

        # the bytes a decode step joins, counted on the card against the
        # reckoning: over two entries of cuda:0 and over cuda:0 and the
        # CPU (where shard 1's K/V stay on the CPU)
        card_cpu = [torch.device("cuda", 0), torch.device("cpu")]
        join_reqs = mesh_requests(cfg, MESH_TIMED_GRID, seed=80)
        counted = {}
        for where, devs in (("card", devices), ("card_cpu", card_cpu)):
            for name, kw in (("dense", dict(kv="dense")),
                             ("paged", dict(kv="paged")),
                             ("int8", dict(kv="paged",
                                           quantize_cache=True))):
                got = mesh_join_per_step(model32, devs, join_reqs, **kw,
                                         **MESH_ENGINE)
                counted[f"{where}_{name}"] = got
                check(got["per_step"] == got["reckoned"],
                      f"mesh: {where} {name} joined {got['per_step']} "
                      f"bytes a step, reckoned {got['reckoned']}")
                check(where == "card" or got["shard1_kv_on_cpu"],
                      f"mesh: {name} over cuda:0 and the CPU left shard "
                      f"1's K/V off the CPU")
        record["join_bytes_per_step"] = counted
        lap("join_count")

        # the card holds what the mesh placed and nothing more: built from
        # a host copy of the model, the mesh adds the held tensors (the
        # whole model, once) over what the single engine adds beside its
        # resident model, in the bytes the allocator was asked for (its
        # blocks round up, by as much as 1 MiB where a cached one is
        # reused whole); a second copy of the model would add 84 MB
        host = D.DALLE(cfg, device="cpu")
        host.load_state_dict(model32.state_dict())
        added, held = {}, None
        for name in ("single", "mesh"):
            gc.collect()
            torch.cuda.synchronize()
            before = torch.cuda.memory_stats()["requested_bytes.all.current"]
            eng = (MeshEngine(host, S.RequestQueue(), devices=devices,
                              kv="paged", **MESH_ENGINE) if name == "mesh"
                   else Engine(model32, S.RequestQueue(), device="cuda",
                               kv="paged", **MESH_ENGINE))
            torch.cuda.synchronize()
            added[name] = (torch.cuda.memory_stats()[
                "requested_bytes.all.current"] - before)
            if name == "mesh":
                held = SS.tensor_bytes(t for shard in eng.held
                                       for t in shard.values())
            del eng
        del host
        over = added["mesh"] - added["single"] - held
        check(held == rep["param_bytes"] and 0 <= over < 2 ** 20,
              f"mesh: a mesh from a host copy added {added['mesh']} bytes "
              f"to the card, the single engine {added['single']}; held "
              f"{held} of {rep['param_bytes']}")
        record["card_bytes_added"] = {**added, "held": held, "over": over}
        lap("card_bytes")

        # two distinct devices, shard 1 on the CPU: its layer fetched to
        # the card when it runs, its rows and heads joined from the CPU,
        # every K/V write and page copy reaching it; float32 tokens equal
        # the single engine's
        split_reqs = mesh_requests(cfg, MESH_SPLIT_GRID, seed=70, short=17)
        cross = {}
        for name, kw in (("dense", dict(kv="dense")),
                         ("paged", dict(kv="paged")),
                         ("int8", dict(kv="paged", quantize_cache=True))):
            want = mesh_run(model32, split_reqs, **kw, **MESH_ENGINE)
            got = mesh_run(model32, split_reqs, card_cpu, **kw,
                           **MESH_ENGINE)
            agree = token_agreement_lists(got["tokens"], want["tokens"])
            eng = got["engine"]
            check(agree["identical_share"] == 1.0,
                  f"mesh: float32 {name} tokens over cuda:0 and the CPU "
                  f"differ from the single engine's: {agree}")
            check(eng.kv_sharded and eng.pool.parts[1]["k"].is_cpu
                  and all(t.is_cpu for t in eng.held[1].values()),
                  f"mesh: {name} over cuda:0 and the CPU left shard 1 "
                  f"off the CPU")
            cross[name] = {
                "identical_share": agree["identical_share"],
                "decode_steps": got["decode_steps"],
                "ms_per_step": got["wall_s"] * 1e3 / got["decode_steps"],
                "single_ms_per_step": (want["wall_s"] * 1e3
                                       / want["decode_steps"])}
        record["card_cpu"] = cross
        del got, want, eng
        lap("card_cpu")

        # the bytes a decode step joins onto devices[0] at the north
        # depth, reckoned from the shapes of meshes built on the CPU
        north, terms = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            big = D.DALLE(north_cfg(), device="cpu", dtype=dtype)
            for name, kw in (("dense", dict(kv="dense")),
                             ("paged", dict(kv="paged")),
                             ("int8", dict(kv="paged",
                                           quantize_cache=True))):
                eng = MeshEngine(big, S.RequestQueue(),
                                 devices=["cpu", "cpu"], **kw, **MESH_ENGINE)
                key = f"{name}_{str(dtype)[6:]}"
                north[key] = eng.step_join_bytes()
                terms[key] = eng.step_join_terms()
                del eng
            del big
        record["north_step_join_bytes"] = north
        record["north_step_join_terms"] = terms
        tcfg_n = north_cfg().transformer
        for key, t in terms.items():
            limit = MESH_NORTH_JOIN_LIMITS[key.split("_")[1]]
            act = 4 if key.endswith("float32") else 2
            check(north[key] <= limit, f"mesh: {north[key]} bytes joined "
                                       f"a step at the north width ({key}), "
                                       f"over {limit}")
            check(t["attention"] == tcfg_n.depth * MESH_ENGINE["num_slots"]
                  * (tcfg_n.heads // MESH_DEVICES) * tcfg_n.dim_head * act,
                  f"mesh: the north attention term {t} is not one row a "
                  f"slot a layer")
        lap("north_join_reckoning")
        try:
            MeshEngine(model32, S.RequestQueue(), devices=devices,
                       kv="paged", paged_attn="kernel", **MESH_ENGINE)
            check(False, "mesh: paged_attn='kernel' was not refused")
        except MeshPagedAttnError as e:
            record["kernel_gate"] = e.record["kind"]

        # a replica set of two mesh slices over four entries of the card
        SS.visible_devices = lambda: [torch.device("cuda", 0)] * 4
        q = S.RequestQueue(max_depth=64,
                           max_prompt_len=cfg.text_seq_len)
        rs = ReplicaSet(model32, q, replicas=2, devices_per_replica=2,
                        kv="paged", bringup_policy=RetryPolicy(
                            max_attempts=1, deadline_s=None,
                            base_backoff_s=0.01, backoff_multiplier=2.0,
                            max_backoff_s=0.1, jitter=0.0),
                        **{**MESH_ENGINE, "chunk_steps": 4})
        try:
            check(all(isinstance(r.engine, MeshEngine) and len(r.device) == 2
                      for r in rs.replicas), "mesh: the set's slices")
            handles = [q.submit(r) for r in reqs]
            with faults.injected(fault_replica=1, replica_crash_at_chunk=2):
                rs.run_until_idle()
            got = [[int(t) for t in h.result(timeout=0).tokens]
                   for h in handles]
            rstats = rs.stats()
            check(rs.failovers == 1 and rs.reclaimed >= 1,
                  f"mesh: failovers {rs.failovers}, reclaimed "
                  f"{rs.reclaimed}")
            check(got == ref["tokens"], "mesh: the replayed tokens differ "
                                        "from the single engine's")
            check(rstats["mesh_shape"] == {"mp": 2}, "mesh: the set's stats")
            record["failover"] = {"failovers": rs.failovers,
                                  "reclaimed": rs.reclaimed,
                                  "completed": rstats["completed"]}
        finally:
            rs.close(timeout=5.0)
        lap("replica_failover")
        del model32, vae32, runs, ref, ref8, paged, rs

        # bfloat16: the server with CLIP, then ms a step
        SS.visible_devices = lambda: devices
        vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
        model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
        clip = CL.clip_init(CL.CLIPConfig(sparse_impl="pallas"), seed=7,
                            dtype=torch.bfloat16)
        srv = InferenceServer(model, vae, clip=clip, mesh_devices=2,
                              kv="paged", **MESH_ENGINE).start()
        try:
            torch.cuda.synchronize()
            BS.block_sparse_attention_fwd.launches = 0
            handles = [srv.submit(r.codes, seed=r.seed,
                                  image_seq_len_override=MESH_GRID)
                       for r in reqs[:2]]
            answers = [h.result(600) for h in handles]
            k3 = BS.block_sparse_attention_fwd.launches
            health = srv.health()
        finally:
            srv.close()
        per_score = clip.cfg.text_enc_depth + clip.cfg.visual_enc_depth
        check(all(a.ok and math.isfinite(a.clip_score) for a in answers),
              f"mesh: the server's answers "
              f"{[(a.status, a.reason) for a in answers]}")
        check(health["ok"] and health["mesh_shape"] == {"mp": 2}
              and health["devices_per_replica"] == 2,
              f"mesh: /healthz {health}")
        check(k3 == per_score * 2, f"mesh: K3 launched {k3} times for 2 "
                                   f"CLIP scores, not {per_score} each")
        record.update(server_health=health, k3_launches=k3)
        lap("server")

        timed_reqs = mesh_requests(cfg, MESH_TIMED_GRID, n=8, seed=60)
        ms = {"single": [], "mesh": []}
        for name in ("single", "mesh", "single", "mesh"):
            run = mesh_run(model, timed_reqs,
                           devices if name == "mesh" else None,
                           kv="paged", **MESH_ENGINE)
            ms[name].append(run["wall_s"] * 1e3 / run["decode_steps"])
        record["bf16_ms_per_decode_step"] = ms
        record["bf16_mesh_over_single"] = min(ms["mesh"]) / min(
            ms["single"])
        lap("bf16_timing")
        record["head_split_bits"] = head_split_bits()
    finally:
        SS.visible_devices = listed
    record["seconds"] = seconds
    emit(**record)
    return record


def token_agreement_lists(a: list, b: list) -> dict:
    """``token_agreement`` over lists of token lists."""
    same = total = 0
    first = []
    for x, y in zip(a, b):
        same += sum(u == v for u, v in zip(x, y))
        total += len(x)
        diff = [i for i, (u, v) in enumerate(zip(x, y)) if u != v]
        first.append(diff[0] if diff else None)
    return {"identical_share": same / max(total, 1),
            "first_divergence": first}


# -- image files --------------------------------------------------------------

IMAGE_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "images")


def phase_images() -> dict:
    """The JPEG fixtures through the port's libjpeg loader against PIL's
    decodes, or the typed refusal where libjpeg is missing; then the
    lossless WebP fixture through libwebp (``ctypes``) against its PIL
    decode stored beside it, or the typed refusal where libwebp is
    missing."""
    import hashlib
    import numpy as np
    from dalle_pytorch_tpu_torch.data import images as IMG
    with open(os.path.join(IMAGE_FIXTURES, "smoke.jpg"), "rb") as fh:
        data = fh.read()
    with open(os.path.join(IMAGE_FIXTURES, "north_256.jpg"), "rb") as fh:
        big = fh.read()
    with open(os.path.join(IMAGE_FIXTURES, "north_256.json")) as fh:
        big_want = json.load(fh)
    record = {"phase": "images", "ok": True}
    try:
        got = IMG.decode_image(data)
    except IMG.UnsupportedImage as e:
        check("libjpeg" in str(e), f"images: the refusal names no "
                                   f"libjpeg: {e}")
        record.update(jpeg="refused", reason=str(e)[-400:])
    else:
        want = np.load(os.path.join(IMAGE_FIXTURES, "smoke_pil_rgb.npy"))
        check(got.shape == want.shape and bool((got == want).all()),
              "images: the JPEG fixture's decode differs from PIL's")
        t0 = time.perf_counter()
        n = 20
        for _ in range(n):
            big_got = IMG.decode_image(big)
        ms = (time.perf_counter() - t0) * 1e3 / n
        check(list(big_got.shape) == big_want["shape"]
              and hashlib.sha256(big_got.tobytes()).hexdigest()
              == big_want["pil_rgb_sha256"],
              "images: the 256 px JPEG's decode differs from PIL's")
        record.update(jpeg="decoded", shape=list(got.shape), max_abs_err=0,
                      decode_ms_256px=ms)
    with open(os.path.join(IMAGE_FIXTURES, "smoke.webp"), "rb") as fh:
        webp = fh.read()
    try:
        got = IMG.decode_image(webp)
    except IMG.UnsupportedImage as e:
        check("libwebp" in str(e), f"images: the WebP refusal names no "
                                   f"libwebp: {e}")
        record.update(webp="refused", webp_reason=str(e)[-400:])
    else:
        want = np.load(os.path.join(IMAGE_FIXTURES, "smoke_webp_rgb.npy"))
        check(got.shape == want.shape and bool((got == want).all()),
              "images: the WebP fixture's decode differs from PIL's")
        lib = IMG._libwebp()
        v = lib.WebPGetDecoderVersion()
        record.update(webp="decoded", webp_shape=list(got.shape),
                      webp_max_abs_err=0,
                      libwebp=f"{v >> 16}.{(v >> 8) & 255}.{v & 255}")
    emit(**record)
    return record


# -- the replica set ----------------------------------------------------------

REPLICA_SET = dict(num_slots=4, chunk_steps=8, kv="paged", page_size=16,
                   paged_attn="kernel")
REPLICA_HTTP_GRID = 256     # image tokens of B's requests (a short grid)
REPLICA_GRID = 128          # image tokens a request (a short grid)
PROCESS_WARM_GRID = 16      # image tokens of B's untimed warm-up wave
# A's float32 schedules, cut from 4 to SERVE_DEPTH for the smoke's time
REPLICA_DEPTH = SERVE_DEPTH
# what the sync schedule gives (``replica_schedule``; the CPU test runs
# the same schedule at a tiny width and holds it to these)
REPLICA_EXPECT = {"failovers": 1, "reclaimed": 4, "migrations": 4,
                  "migrate_fallbacks": 0, "upgrades": 1,
                  # 18 requests and one canary a replica
                  "completed": 20, "scale_ins": 0, "scale_outs": 0}
# the set's structured events of the schedule, by kind
REPLICA_EVENTS = {"serve_replica_crash": 1, "serve_replica_fenced": 4,
                  "serve_replica_up": 6, "serve_migrated": 4,
                  "serve_upgrade_begin": 1, "serve_upgrade_replica": 2,
                  "serve_upgrade_done": 1}


def replica_requests(cfg, n: int, seed: int) -> list:
    """``n`` requests with full-span prompts, capped at REPLICA_GRID
    image tokens, seeds from ``seed``."""
    import numpy as np
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    rng = np.random.default_rng(seed)
    return [S.Request(codes=tuple(int(c) for c in rng.integers(
        1, cfg.num_text_tokens, cfg.text_seq_len)), seed=seed + i,
        image_seq_len_override=REPLICA_GRID) for i in range(n)]


REPLICA_STEPS: list = []     # (decode steps, wall s) of each reference


def replica_reference(model, reqs, device) -> list:
    """Each request's tokens from ONE engine with the replicas' shapes;
    its decode steps and wall go to REPLICA_STEPS."""
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    q = S.RequestQueue(max_depth=64)
    eng = Engine(model, q, device=device, **REPLICA_SET)
    handles = [q.submit(r) for r in reqs]
    t0 = time.perf_counter()
    eng.run_until_idle()
    REPLICA_STEPS.append((eng.decode_steps, time.perf_counter() - t0))
    out = []
    for h in handles:
        res = h.result(timeout=0)
        check(res.ok, f"replicas: reference request {res.request_id}: "
                      f"{res.status} {res.reason}")
        out.append([int(t) for t in res.tokens])
    return out


class LockWatch:
    """The lock-order sanitizer (``analysis/guards.py``) over a replica
    set: its control lock and flight ring, its queue, each engine's
    locks (``_lock``, ``_profile_lock``) and flight ring, the engines it
    brings up later too, the handles and traces submitted through
    ``submit``, and K4's module lock (``ops/paged_attention.py::_LOCK``).
    ``stop`` puts every lock back as it was. An inversion raised
    in a replica's step, which the set takes for a replica fault, stays
    in ``rec.errors``."""

    def __init__(self, rs, q):
        from dalle_pytorch_tpu_torch.analysis import guards as G
        from dalle_pytorch_tpu_torch.ops import paged_attention as PA
        from dalle_pytorch_tpu_torch.serve.engine import Engine
        self.G, self.PA, self.Engine = G, PA, Engine
        self.rec = G.LockOrderRecorder()
        self.rs, self.q = rs, q
        self.objs = []
        self.init = Engine.__init__

    def watch(self, *objs) -> None:
        for obj in objs:
            if obj is not None:
                self.G.instrument_locks(obj, self.rec)
                self.objs.append(obj)

    def start(self) -> None:
        init, watch = self.init, self.watch

        def watched_init(engine, *args, **kwargs):
            init(engine, *args, **kwargs)
            watch(engine, engine.flight)

        self.Engine.__init__ = watched_init
        self.G.instrument_module_lock(self.PA, "_LOCK", self.rec)
        self.watch(self.rs, self.rs.flight, self.q)
        for r in self.rs.replicas:
            if r.engine is not None:
                self.watch(r.engine, r.engine.flight)

    def submit(self, request):
        h = self.q.submit(request)
        self.watch(h, h.trace)
        return h

    def stop(self) -> None:
        self.Engine.__init__ = self.init
        self.G.restore_locks(self.PA)
        for obj in self.objs:
            self.G.restore_locks(obj)


@functools.lru_cache(maxsize=None)
def port_lock_edges() -> frozenset:
    """The port's static lock-order graph: its racelint's
    ``lock_order_edges`` over the package."""
    import dalle_pytorch_tpu_torch
    from dalle_pytorch_tpu_torch.analysis import racelint
    pkg = os.path.dirname(dalle_pytorch_tpu_torch.__file__)
    return frozenset(racelint.lock_order_edges(
        racelint.iter_py_files([pkg])))


def replica_schedule(model_v1, model_v2, device) -> dict:
    """The sync-driver schedule of ``phase_replicas`` A on any device:
    four waves through a crash, a drain with live migration, a rolling
    upgrade and the promoted version. Returns each wave's results
    (status, weights_version, tokens), the set's counters and events,
    the K4 launches each replica's engine made (attributed step by
    step: under the sync driver one thread steps them in turn), and the
    lock-order edges and inversions ``LockWatch`` saw."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.resilience import faults
    from dalle_pytorch_tpu_torch.resilience import retry
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    from dalle_pytorch_tpu_torch.serve.replica import DRAINED, ReplicaSet
    cfg = model_v1.cfg
    events = []

    times = []

    class Sink:
        def event(self, **rec):
            events.append(rec.get("kind"))
            times.append((rec.get("kind"), time.perf_counter()))

    fast = retry.RetryPolicy(max_attempts=1, deadline_s=None,
                             base_backoff_s=0.01, backoff_multiplier=2.0,
                             max_backoff_s=0.1, jitter=0.0)
    q = S.RequestQueue(max_depth=64)
    rs = ReplicaSet(model_v1, q, replicas=2, weights_version="v1",
                    bringup_policy=fast, metrics=Sink(), device=device,
                    **REPLICA_SET)
    k4 = {}
    step = Engine.step_once

    def counted(engine):
        before = PA.paged_decode_attention.launches
        try:
            return step(engine)
        finally:
            idx = next((r.index for r in rs.replicas
                        if r.engine is engine), -1)
            k4[idx] = k4.get(idx, 0) + \
                PA.paged_decode_attention.launches - before

    def pump_until(pred, what, limit=100_000):
        for _ in range(limit):
            if pred():
                return
            rs.step_once()
        check(False, f"replicas: {what} never happened")

    def mid_stream(need):
        """Every replica has ``need`` requests decoding, each at least two
        chunks in."""
        live = [r for r in rs.replicas if r.engine is not None]
        return all(len(r.engine.progress_snapshot()) == need and all(
            v >= 16 for v in r.engine.progress_snapshot().values())
            for r in live)

    Engine.step_once = counted
    locks = LockWatch(rs, q)
    locks.start()
    try:
        waves = {"crash": replica_requests(cfg, 8, 100),
                 "drain": replica_requests(cfg, 4, 200),
                 "upgrade": replica_requests(cfg, 4, 300),
                 "v2": replica_requests(cfg, 2, 400)}
        handles = {}
        handles["crash"] = [locks.submit(r) for r in waves["crash"]]
        with faults.injected(fault_replica=1, replica_crash_at_chunk=2):
            rs.run_until_idle()
        handles["drain"] = [locks.submit(r) for r in waves["drain"]]
        pump_until(lambda: mid_stream(2), "two requests mid-stream on "
                                          "each replica")
        t0 = time.perf_counter()
        drained = rs.drain_replica(0)
        drain_s = time.perf_counter() - t0
        check(rs.replicas[0].state == DRAINED, "replicas: not drained")
        rs.run_until_idle()
        check(rs.undrain_replica(0), "replicas: undrain failed")
        handles["upgrade"] = [locks.submit(r) for r in waves["upgrade"]]
        pump_until(lambda: mid_stream(2), "the upgrade wave mid-stream")
        t0 = time.perf_counter()
        upgrade = rs.rolling_upgrade(
            version="v2", params=model_v2, canaries=1,
            canary_codes=[waves["v2"][0].codes], replica_timeout_s=600.0)
        upgrade_s = time.perf_counter() - t0
        rs.run_until_idle()
        handles["v2"] = [locks.submit(r) for r in waves["v2"]]
        rs.run_until_idle()
    finally:
        Engine.step_once = step
        locks.stop()
    # the crash's cost: from the crash to the replacement engine's up
    t_crash = next(t for k, t in times if k == "serve_replica_crash")
    failover_s = next(t for k, t in times if k == "serve_replica_up"
                      and t > t_crash) - t_crash
    results = {w: [(h.result(timeout=0).status,
                    h.result(timeout=0).weights_version,
                    [int(t) for t in h.result(timeout=0).tokens]
                    if h.result(timeout=0).tokens is not None else None)
                   for h in hs] for w, hs in handles.items()}
    stats = rs.stats()
    counters = {k: stats[k] for k in REPLICA_EXPECT}
    return {"waves": waves, "results": results, "counters": counters,
            "events": events, "k4_by_replica": k4, "drained": drained,
            "drain_s": drain_s, "upgrade_s": upgrade_s,
            "failover_s": failover_s,
            "migration_s": list(rs.migration_seconds),
            "upgrade": upgrade, "stats": stats,
            "pages_in_use": [r.engine.alloc.in_use for r in rs.replicas
                             if r.engine is not None],
            "lock_edges": sorted(locks.rec.edges()),
            "lock_errors": [str(e) for e in locks.rec.errors]}


def check_replica_schedule(run: dict, want: dict) -> None:
    """Each wave's results ok with the single engine's tokens of the
    version that stamped them; the counters as predicted; no page
    leaked; no lock-order inversion, and every lock order seen one that
    the port's racelint predicts."""
    for wave, res in run["results"].items():
        for i, (status, version, toks) in enumerate(res):
            check(status == "ok", f"replicas: {wave} #{i} {status}")
            check(toks == want[version][wave][i],
                  f"replicas: {wave} #{i} ({version}) differs from the "
                  f"single engine's tokens")
    check(run["counters"] == REPLICA_EXPECT,
          f"replicas: counters {run['counters']}, the CPU schedule gives "
          f"{REPLICA_EXPECT}")
    events = {k: run["events"].count(k) for k in set(run["events"])}
    check(events == REPLICA_EVENTS,
          f"replicas: events {events}, the CPU schedule gives "
          f"{REPLICA_EVENTS}")
    check(all(n == 0 for n in run["pages_in_use"]),
          f"replicas: pages left mapped {run['pages_in_use']}")
    check(not run["lock_errors"],
          f"replicas: lock-order inversions {run['lock_errors']}")
    unpredicted = sorted(set(map(tuple, run["lock_edges"]))
                         - port_lock_edges())
    check(not unpredicted,
          f"replicas: lock orders racelint does not predict {unpredicted}")


def replica_http_wave(srv, client, prompt, n: int, events=None,
                      grid: int = 0) -> dict:
    """``n`` clients at once, one request each (``grid``: a short grid
    of that many image tokens); ``events(client)`` runs mid-wave.
    Returns the wall, the results and the events' answers."""
    import threading
    out, errors = {}, []
    extra = {"image_seq_len_override": grid} if grid else {}

    def run(i):
        try:
            out[i] = client.json("POST", "/generate",
                                 {"codes": prompt, "seed": 40 + i, **extra})
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    answers = events(client) if events is not None else None
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    check(not errors and len(out) == n, f"replicas: client failures "
                                        f"{errors}")
    return {"wall": wall, "results": [out[i] for i in range(n)],
            "answers": answers}


def replica_serving(model, vae, device) -> dict:
    """Phase B on any device: the HTTP server over a set of 1 replica and
    of 2 (six clients each, one wave), then a wave through ``POST
    /admin/scale`` add and remove-with-drain. Returns the record."""
    import threading
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    from dalle_pytorch_tpu_torch.serve.server import (InferenceServer,
                                                      make_http_server)
    cfg = model.cfg
    g = torch.Generator().manual_seed(16)
    # full-span prompts: REPLICA_HTTP_GRID decode steps a request
    prompt = [int(t) for t in torch.randint(1, cfg.num_text_tokens,
                                            (cfg.text_seq_len,),
                                            generator=g)]
    server_kw = dict(num_slots=4, chunk_steps=8, kv="paged", page_size=16,
                     paged_attn="kernel", admin_token=HTTP_TOKEN,
                     max_replicas=3)
    size = cfg.vae.image_size
    PA.paged_decode_attention.launches = 0
    timing = {}
    for n in (1, 2):
        srv = InferenceServer(model, vae, replicas=n, device=device,
                              **server_kw).start()
        httpd = make_http_server(srv, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        client = HttpClient(httpd.server_address[1])
        try:
            wave = replica_http_wave(srv, client, prompt, 6,
                                     grid=REPLICA_HTTP_GRID)
            steps = max(r.engine.decode_steps for r in srv.engine.replicas
                        if r.engine is not None)
            timing[n] = {"wall_s": wave["wall"], "decode_steps": steps,
                         "ms_per_decode_step": wave["wall"] * 1e3 / steps,
                         "image_tokens_per_s":
                             6 * REPLICA_HTTP_GRID / wave["wall"]}
            waves = [wave]
            if n == 2:
                base = client.json("GET", "/stats")[1]["decode_steps"]

                def reshape(c):
                    # eight chunks into the wave: requests mid-stream
                    wait_for("a decoding wave", lambda: c.json(
                        "GET", "/stats")[1]["decode_steps"] >= base + 64)
                    add = c.json("POST", "/admin/scale", {"op": "add"},
                                 token=HTTP_TOKEN)
                    remove = c.json("POST", "/admin/scale",
                                    {"op": "remove", "replica": 0},
                                    token=HTTP_TOKEN)
                    return {"add": add, "remove": remove}
                scaled = replica_http_wave(srv, client, prompt, 6,
                                           events=reshape,
                                           grid=REPLICA_HTTP_GRID)
                waves.append(scaled)
                stats = client.json("GET", "/stats")[1]
                health = client.json("GET", "/healthz")
            for w in waves:
                for code, body in w["results"]:
                    check(code == 200 and body["status"] == "ok"
                          and len(body["tokens"]) == REPLICA_HTTP_GRID
                          and 0 <= min(body["tokens"])
                          and max(body["tokens"]) < cfg.num_image_tokens
                          and body["image_shape"] == [size, size, 3],
                          f"replicas: B result {code} "
                          f"{body.get('status')}")
        finally:
            httpd.shutdown()
            httpd.server_close()
            srv.close()
    k4 = PA.paged_decode_attention.launches
    answers = scaled["answers"]
    check(answers["add"][0] == 200 and answers["add"][1]["replicas"] == 3,
          f"replicas: /admin/scale add answered {answers['add']}")
    check(answers["remove"][0] == 200
          and answers["remove"][1]["replicas"] == 2,
          f"replicas: /admin/scale remove answered {answers['remove']}")
    check(stats["scale_outs"] == 1 and stats["scale_ins"] == 1
          and stats["completed"] == 12 and stats["failovers"] == 0,
          f"replicas: B stats {stats}")
    check(health[0] == 200 and len(health[1]["replicas"]) == 3,
          f"replicas: /healthz {health}")
    return {
        "depth": cfg.depth, "dtype": str(model.text_emb.weight.dtype),
        **server_kw, "prompt_len": cfg.text_seq_len, "clients": 6,
        "one_replica": timing[1], "two_replicas": timing[2],
        "speedup": timing[2]["image_tokens_per_s"]
        / timing[1]["image_tokens_per_s"],
        "scaled_wave_s": scaled["wall"],
        "migrations": stats["migrations"],
        "migrated_tokens_saved": stats["migrated_tokens_saved"],
        "reclaimed": stats["reclaimed"], "k4_launches": k4}



def phase_replicas() -> dict:
    """A: the sync schedule (``replica_schedule``) in float32 at
    REPLICA_DEPTH;
    B: the HTTP server over a replica set in bfloat16 at SERVE_DEPTH
    (``replica_serving``)."""
    import dataclasses
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    record = {"phase": "replicas", "ok": True}
    # A
    cfg = dataclasses.replace(north_cfg(), depth=REPLICA_DEPTH)
    v1 = D.dalle_init(cfg, seed=4, dtype=torch.float32)
    v2 = D.dalle_init(cfg, seed=5, dtype=torch.float32)
    t0 = time.perf_counter()
    run = replica_schedule(v1, v2, "cuda")
    set_s = time.perf_counter() - t0
    waves = run["waves"]
    t0 = time.perf_counter()
    want = {"v1": {w: replica_reference(v1, waves[w], "cuda")
                   for w in ("crash", "drain", "upgrade")},
            "v2": {"v2": replica_reference(v2, waves["v2"], "cuda")}}
    reference_s = time.perf_counter() - t0
    steps, wall = map(sum, zip(*REPLICA_STEPS))
    check_replica_schedule(run, want)
    k4 = run["k4_by_replica"]
    check(k4.get(0, 0) > 0 and k4.get(1, 0) > 0,
          f"replicas: K4 did not run in both replicas: {k4}")
    record["A"] = {
        "depth": cfg.depth, "dtype": "float32", **REPLICA_SET,
        "grid": REPLICA_GRID, "counters": run["counters"],
        "k4_by_replica": {str(k): v for k, v in k4.items()},
        "set_s": set_s, "reference_s": reference_s,
        "ms_per_engine_step": wall * 1e3 / steps,
        "drain_s": run["drain_s"], "drained": run["drained"],
        "failover_s": run["failover_s"],
        "migration_s": run["migration_s"],
        "upgrade_s": run["upgrade_s"],
        "upgrade_replicas": run["upgrade"]["replicas"],
        "events": {k: run["events"].count(k) for k in sorted(
            set(run["events"]))},
        "lock_edges": [f"{a} -> {b}" for a, b in run["lock_edges"]],
        "lock_edges_static": len(port_lock_edges())}
    emit(**record["A"], phase="replicas", part="A", ok=True)
    del v1, v2
    torch.cuda.empty_cache()

    # B
    cfg = dataclasses.replace(north_cfg(), depth=SERVE_DEPTH)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    record["B"] = replica_serving(model, vae, "cuda")
    check(record["B"]["k4_launches"] > 0,
          "replicas: K4 never launched under the server")
    record["k4_launches"] = record["B"]["k4_launches"]
    emit(**record["B"], phase="replicas", part="B", ok=True)
    return record



# process replicas (``isolation='process'``): A's schedule, B's server, C's
# socket worker; f32 A at REPLICA_DEPTH, B at SERVE_DEPTH in bfloat16
PROCESS_WAIT_S = 600.0
# the RSS watchdog's limit: the children's READY resident size plus this
PROCESS_RSS_MARGIN_MB = 4096


def process_drive(rs, pred, what: str, timeout_s: float = PROCESS_WAIT_S):
    """Step the set's sync driver until ``pred()``, at most
    ``timeout_s``."""
    deadline = time.perf_counter() + timeout_s
    while not pred():
        check(time.perf_counter() < deadline,
              f"processes: {what} not seen in {timeout_s:g} s")
        rs.step_once()


def process_ready(rs) -> bool:
    from dalle_pytorch_tpu_torch.serve.replica import DRAINED, RUNNING
    return all(r.state == RUNNING and r.engine is not None
               and r.engine.ready for r in rs.replicas
               if r.state != DRAINED)


def process_idle(rs) -> None:
    process_drive(rs, lambda: rs.idle() and not rs.step_once(),
                  "an idle set")


def process_schedule(model_v1, model_v2) -> dict:
    """A: the sync driver over 2 child replicas on the card, dialing back
    over the socket transport (127.0.0.1, a token). Child 1 dies three
    ways, each replacement spawned under the next plan (a plan crosses
    at spawn, once): a real SIGKILL at its 2nd chunk, a garbage frame,
    its RSS watchdog (limit: READY's RSS + ``PROCESS_RSS_MARGIN_MB``), a
    wave each; then a rolling upgrade to ``model_v2`` (one canary a
    replica, each replica's decoding requests live-migrated before it is
    fenced), a wave on v2, and a drain of child 0 that live-migrates its
    decoding requests to child 1 (left drained). Returns each wave's
    results, the set's stats and events, failover and migration seconds,
    and the children's bring-up records and RSS."""
    from dalle_pytorch_tpu_torch.resilience import faults
    from dalle_pytorch_tpu_torch.resilience import retry
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.replica import DRAINED, ReplicaSet
    cfg = model_v1.cfg
    events = []

    class Sink:
        def event(self, **rec):
            events.append((rec.get("kind"), rec.get("replica"),
                           time.perf_counter(),
                           {k: rec.get(k) for k in ("reason", "exit",
                                                    "pid")}))

    fast = retry.RetryPolicy(max_attempts=1, deadline_s=None,
                             base_backoff_s=0.01, backoff_multiplier=2.0,
                             max_backoff_s=0.1, jitter=0.0)
    waves = {"sigkill": replica_requests(cfg, 8, 500),
             "garbage": replica_requests(cfg, 4, 600),
             "watchdog": replica_requests(cfg, 4, 700),
             "upgrade": replica_requests(cfg, 4, 900),
             "v2": replica_requests(cfg, 2, 1000),
             "drain": replica_requests(cfg, 4, 800)}
    handles, exits, rss, boots = {}, {}, {}, {}
    q = S.RequestQueue(max_depth=64)
    t0 = time.perf_counter()
    faults.activate(faults.FaultPlan(fault_replica=1,
                                     replica_sigkill_at_chunk=2))
    rs = ReplicaSet(model_v1, q, replicas=2, weights_version="v1",
                    bringup_policy=fast, metrics=Sink(), device="cuda",
                    isolation="process", transport="socket",
                    attach_token="smoke-worker", spawn_timeout_s=300.0,
                    compile_grace_s=300.0, **REPLICA_SET)
    try:
        process_drive(rs, lambda: process_ready(rs), "both READY")
        bringup_s = time.perf_counter() - t0
        rss["ready"] = [r.engine.rss_mb for r in rs.replicas]
        boots["initial"] = [r.engine.boot_s for r in rs.replicas]
        for n, (wave, plan) in enumerate((
                ("sigkill", {"replica_garbage_frame_at_chunk": 2}),
                ("garbage", {"replica_oom_at_chunk": 2}),
                ("watchdog", None)), start=1):
            handles[wave] = [q.submit(r) for r in waves[wave]]
            process_drive(rs, lambda: rs.failovers >= n,
                          f"the {wave} fence")
            exits[wave] = rs.replicas[1].last_exit
            # the replacement spawns on the next sweep: under this plan
            if plan is None:
                faults.deactivate()
                rs.child_rss_limit_mb = 0
            else:
                faults.activate(faults.FaultPlan(fault_replica=1, **plan))
                if "replica_oom_at_chunk" in plan:
                    rs.child_rss_limit_mb = max(rss["ready"]) \
                        + PROCESS_RSS_MARGIN_MB
            process_idle(rs)
            process_drive(rs, lambda: process_ready(rs),
                          f"the replacement after {wave}")
            if wave == "sigkill":
                boots["replacement"] = rs.replicas[1].engine.boot_s

        handles["upgrade"] = [q.submit(r) for r in waves["upgrade"]]
        process_drive(rs, lambda: any(
            v >= 16 for r in rs.replicas
            for v in r.engine.progress.values()),
            "the upgrade wave mid-stream")
        t1 = time.perf_counter()
        upgrade = rs.rolling_upgrade(
            version="v2", params=model_v2, canaries=1,
            canary_codes=[waves["v2"][0].codes], replica_timeout_s=600.0)
        upgrade_s = time.perf_counter() - t1
        process_idle(rs)
        handles["v2"] = [q.submit(r) for r in waves["v2"]]
        process_idle(rs)

        handles["drain"] = [q.submit(r) for r in waves["drain"]]
        process_drive(rs, lambda: any(
            v >= 16 for v in rs.replicas[0].engine.progress.values()),
            "a request two chunks into decode on child 0")
        t1 = time.perf_counter()
        drained = rs.drain_replica(0)
        drain_s = time.perf_counter() - t1
        check(rs.replicas[0].state == DRAINED, "processes: not drained")
        process_idle(rs)
        stats = rs.stats()
        rss["end"] = [r.engine.rss_mb for r in rs.replicas
                      if r.engine is not None]
    finally:
        faults.deactivate()
        rs.close()
    # failover: child 1's fence after the SIGKILL -> its replacement's READY
    t_fence = next(t for k, i, t, _ in events
                   if k == "serve_replica_fenced" and i == 1)
    failover_s = next(t for k, i, t, _ in events
                      if k == "serve_replica_up" and i == 1
                      and t > t_fence) - t_fence
    results = {w: [(h.result(timeout=0).status,
                    h.result(timeout=0).weights_version,
                    [int(t) for t in h.result(timeout=0).tokens]
                    if h.result(timeout=0).tokens is not None else None)
                   for h in hs] for w, hs in handles.items()}
    return {"waves": waves, "results": results, "stats": stats,
            "events": [e[:2] + (e[3],) for e in events], "exits": exits,
            "rss_mb": rss, "bringup_s": bringup_s, "boot_s": boots,
            "failover_s": failover_s,
            "drain_s": drain_s, "drained": drained, "upgrade_s": upgrade_s,
            "upgrade": upgrade, "migration_s": list(rs.migration_seconds)}


def check_process_schedule(run: dict, want: dict) -> None:
    """Every result ok with the single engine's f32 tokens of its version;
    three failovers (SIGKILL, garbage, watchdog) each with its death;
    no request lost and every delivered token counted once; K4 in every
    child."""
    for wave, res in run["results"].items():
        for i, (status, version, toks) in enumerate(res):
            check(status == "ok", f"processes: {wave} #{i} {status}")
            check(toks == want[version][wave][i],
                  f"processes: {wave} #{i} ({version}) differs from the "
                  f"single engine's tokens")
    st, ex = run["stats"], run["exits"]
    n = sum(len(r) for r in run["results"].values())
    check(st["failovers"] == 3, f"processes: failovers {st['failovers']}")
    check("killed by SIGKILL" in ex["sigkill"]
          and "oom-killed (exit 137" in ex["watchdog"],
          f"processes: exits {ex}")
    fenced = [e for k, i, e in run["events"]
              if k == "serve_replica_fenced"]
    check(any("protocol error" in (e["reason"] or "") for e in fenced),
          f"processes: no fence on the garbage frame: {fenced}")
    # every request once, plus one canary a replica (a full grid each)
    check(st["completed"] == n + 2, f"processes: completed "
                                    f"{st['completed']}, not {n} + 2")
    check(st["tokens_decoded"] == n * REPLICA_GRID + 2
          * run["upgrade_canary_tokens"],
          f"processes: tokens_decoded {st['tokens_decoded']}: a replayed "
          f"request counted twice or not at all")
    check(st["migrations"] >= 1 and st["migrate_fallbacks"] == 0,
          f"processes: migrations {st['migrations']}, fallbacks "
          f"{st['migrate_fallbacks']}")
    check(st["transport"] == "socket" and st["attach_rejected"] == 0
          and all(p["peer"].startswith("127.0.0.1:")
                  for p in st["per_replica"] if "peer" in p),
          f"processes: the socket workers {st['per_replica']}")
    for p in st["per_replica"]:
        check(p["state"] != "running"
              or p.get("paged_decode_launches", 0) > 0,
              f"processes: K4 did not run in child {p['replica']}: {p}")
    check(st["paged_decode_launches"] > 0,
          f"processes: K4 never ran in A's children: {st}")


def child_step_ms(live, wave, keys=None) -> tuple:
    """Run ``wave()`` while sampling each child's ``step_clock`` (its own
    clock at its last frame and its decode steps then). Returns the
    wave's result and each child's ms a step, under its replica index
    or its entry of ``keys``: its clock from the first frame of the wave
    that counted a step to its last frame, over the steps between them
    (the child's own time, not the wave's wall)."""
    import threading
    keys = [r.index for r in live] if keys is None else list(keys)
    before = {k: r.engine.step_clock[1] for k, r in zip(keys, live)}
    seen = {k: [] for k in keys}
    stop = threading.Event()

    def sample():
        while True:
            for k, r in zip(keys, live):
                t, steps = r.engine.step_clock
                if steps > before[k] and (
                        not seen[k] or seen[k][-1][1] != steps):
                    seen[k].append((t, steps))
            if stop.is_set():
                return
            stop.wait(0.002)

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        out = wave()
        # the last frames carry the wave's steps
        wait_for("the children's last frames",
                 lambda: all(r.engine.active_slots() == 0 for r in live), 60)
    finally:
        stop.set()
        sampler.join(10)
    ms = {i: (s[-1][0] - s[0][0]) * 1e3 / (s[-1][1] - s[0][1])
          for i, s in seen.items() if len(s) > 1}
    return out, ms


def process_serving(model, vae, clip, thread_pair) -> dict:
    """B: the HTTP server over 2 child replicas in bfloat16 (4 slots
    each), CLIP scoring in the parent's postprocess worker: an untimed
    warm-up wave on both children (a child's first requests pay its
    context's first dispatches), six clients with both children, then
    six with child 1 drained (one serves; no respawn). Image tokens a
    second, each child's ms a step (``child_step_ms``) and K4 launches
    from its frames, the ratio of 2 over 1 and of this pair over
    ``thread_pair`` (the ``replicas`` phase's B, the same call)."""
    import threading
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.serve.server import (InferenceServer,
                                                      make_http_server)
    cfg = model.cfg
    g = torch.Generator().manual_seed(16)
    prompt = [int(t) for t in torch.randint(1, cfg.num_text_tokens,
                                            (cfg.text_seq_len,),
                                            generator=g)]
    server_kw = dict(num_slots=4, chunk_steps=8, kv="paged", page_size=16,
                     paged_attn="kernel", admin_token=HTTP_TOKEN)
    size = cfg.vae.image_size
    srv = InferenceServer(model, vae, clip=clip, replicas=2,
                          isolation="process", device="cuda",
                          **server_kw).start()
    httpd = make_http_server(srv, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    client = HttpClient(httpd.server_address[1])
    rs = srv.engine
    timing = {}
    try:
        wait_for("both children READY", lambda: process_ready(rs), 600)
        warm = replica_http_wave(srv, client, prompt, 6,
                                 grid=PROCESS_WARM_GRID)
        check(all(code == 200 and body["status"] == "ok"
                  for code, body in warm["results"]),
              f"processes: B warm-up {warm['results']}")
        wait_for("the warm-up's last frames",
                 lambda: all(r.engine.active_slots() == 0
                             for r in rs.replicas), 60)
        check(all(r.engine.decode_steps > 0 for r in rs.replicas),
              "processes: the warm-up wave missed a child")
        BS.block_sparse_attention_fwd.launches = 0
        for n in (2, 1):
            if n == 1:
                # one child serves: drain the other (no respawn)
                code, body = client.json("POST", "/admin/scale",
                                         {"op": "drain", "replica": 1},
                                         token=HTTP_TOKEN)
                check(code == 200, f"processes: drain answered {code}")
            live = [r for r in rs.replicas if r.engine is not None]
            before = {r.index: r.engine.decode_steps for r in live}
            wave, step_ms = child_step_ms(live, lambda: replica_http_wave(
                srv, client, prompt, 6, grid=REPLICA_HTTP_GRID))
            steps = {r.index: r.engine.decode_steps - before[r.index]
                     for r in live}
            for code, body in wave["results"]:
                check(code == 200 and body["status"] == "ok"
                      and len(body["tokens"]) == REPLICA_HTTP_GRID
                      and body["image_shape"] == [size, size, 3]
                      and body.get("clip_score") is not None,
                      f"processes: B result {code} {body.get('status')}")
            timing[n] = {
                "wall_s": wave["wall"], "decode_steps": steps,
                "k4_by_child": {r.index: r.engine.paged_decode_launches
                                for r in live},
                "ms_per_decode_step": step_ms,
                "image_tokens_per_s": 6 * REPLICA_HTTP_GRID / wave["wall"]}
        k3 = BS.block_sparse_attention_fwd.launches
        stats = client.json("GET", "/stats")[1]
        health = client.json("GET", "/healthz")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    per_score = clip.cfg.text_enc_depth + clip.cfg.visual_enc_depth
    check(k3 == per_score * 12, f"processes: K3 launched {k3} times for "
                                f"12 CLIP scores, not {per_score} each")
    reps = health[1]["replicas"]
    check(health[0] == 200 and reps[1]["state"] == "drained"
          and reps[0]["alive"] and reps[0]["pid"] > 0
          and reps[0]["transport"] == "pipe", f"processes: /healthz "
                                              f"{health}")
    per = [p for p in stats["per_replica"] if "pid" in p]
    check(all(n > 0 for n in timing[2]["k4_by_child"].values()),
          f"processes: K4 did not run in every child: {timing[2]}")
    check(all(len(timing[n]["ms_per_decode_step"]) == n for n in (1, 2)),
          f"processes: a child's ms a step is missing: {timing}")
    check(stats["completed"] == 18 and stats["failovers"] == 0,
          f"processes: B stats {stats}")
    speed = timing[2]["image_tokens_per_s"] / \
        timing[1]["image_tokens_per_s"]
    return {"depth": cfg.depth, "dtype": str(model.text_emb.weight.dtype),
            **server_kw, "prompt_len": cfg.text_seq_len, "clients": 6,
            "grid": REPLICA_HTTP_GRID, "one_child": timing[1],
            "two_children": timing[2], "speedup": speed,
            "over_thread_pair": (
                None if thread_pair is None
                else timing[2]["image_tokens_per_s"] / thread_pair),
            "thread_pair_image_tokens_per_s": thread_pair,
            "rss_mb": [p["rss_mb"] for p in per],
            "ipc_lag_p50_ms": [p.get("ipc_lag_p50_ms") for p in per],
            "k4_launches": stats["paged_decode_launches"],
            "k3_launches": k3}


def phase_processes(fleet=None) -> dict:
    """A (``process_schedule``, f32 at REPLICA_DEPTH, socket workers)
    against single engines of each version; B (``process_serving``, bf16
    at SERVE_DEPTH, pipes) beside the ``replicas`` phase's thread pair of
    this call (``fleet``)."""
    import dataclasses
    from dalle_pytorch_tpu_torch.models import clip as CL
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    record = {"phase": "processes", "ok": True}
    # A
    cfg = dataclasses.replace(north_cfg(), depth=REPLICA_DEPTH)
    v1 = D.dalle_init(cfg, seed=4, dtype=torch.float32)
    v2 = D.dalle_init(cfg, seed=5, dtype=torch.float32)
    t0 = time.perf_counter()
    run = process_schedule(v1, v2)
    set_s = time.perf_counter() - t0
    waves = run["waves"]
    want = {"v1": {w: replica_reference(v1, waves[w], "cuda")
                   for w in ("sigkill", "garbage", "watchdog", "upgrade")},
            "v2": {w: replica_reference(v2, waves[w], "cuda")
                   for w in ("v2", "drain")}}
    # a canary decodes the full grid
    run["upgrade_canary_tokens"] = cfg.image_seq_len
    check_process_schedule(run, want)
    st = run["stats"]
    record["A"] = {
        "depth": cfg.depth, "dtype": "float32", **REPLICA_SET,
        "grid": REPLICA_GRID, "set_s": set_s,
        "bringup_s": run["bringup_s"], "boot_s": run["boot_s"],
        "failover_s": run["failover_s"],
        "migration_s": run["migration_s"], "drain_s": run["drain_s"],
        "drained": run["drained"], "upgrade_s": run["upgrade_s"],
        "upgrade_replicas": run["upgrade"]["replicas"],
        "exits": run["exits"], "rss_mb": run["rss_mb"],
        "counters": {k: st[k] for k in (
            "completed", "tokens_decoded", "failovers", "reclaimed",
            "migrations", "migrate_fallbacks", "migrated_tokens_saved",
            "upgrades", "bringup_failures")},
        "children": [{k: p.get(k) for k in (
            "state", "transport", "peer", "paged_decode_launches",
            "ipc_lag_p50_ms", "restarts", "last_exit")}
            for p in st["per_replica"]],
        "attach_rejected": st["attach_rejected"],
        "k4_launches": st["paged_decode_launches"]}
    emit(**record["A"], phase="processes", part="A", ok=True)
    del v1, v2
    torch.cuda.empty_cache()

    # B
    cfg = dataclasses.replace(north_cfg(), depth=SERVE_DEPTH)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    clip = CL.clip_init(CL.CLIPConfig(sparse_impl="pallas"), seed=7,
                        dtype=torch.bfloat16)
    pair = None if fleet is None \
        else fleet["B"]["two_replicas"]["image_tokens_per_s"]
    record["B"] = process_serving(model, vae, clip, pair)
    record["k4_launches"] = record["B"]["k4_launches"]
    record["k3_launches"] = record["B"]["k3_launches"]
    emit(**record["B"], phase="processes", part="B", ok=True)
    return record



# the gateway (``serve/gateway.py``) over cells of servers: A's thread
# cells in float32, B's process cells in bfloat16, both at SERVE_DEPTH
GATEWAY_CELL = dict(num_slots=4, chunk_steps=8, kv="paged", page_size=16,
                    paged_attn="kernel", prefix_cache=True)
GATEWAY_VERSION = "smoke"
GATEWAY_ROUTE_GRID = 16     # the routing waves' (only their prompts count)
GATEWAY_VICTIM_GRID = 128   # B's victim requests
GATEWAY_FLOOD = 24          # the tenant_flood row's abuser submits
GATEWAY_WAIT_S = 300.0
GATEWAY_TENANTS_A = [{"name": "std", "key": "ks"},
                     {"name": "gold", "key": "kg", "tier": "gold",
                      "hedge_s": 0.0}]
GATEWAY_TENANTS_B = [{"name": "victim", "key": "kv", "weight": 2.0},
                     {"name": "abuser", "key": "ka", "weight": 1.0,
                      "rps": 2.0}]


def gateway_over(cells, cfg, tenants=None, **kw):
    """A started ``Gateway`` over started ``cells``, keyed as the cells'
    engines key their prefix caches."""
    from dalle_pytorch_tpu_torch.serve import TenantTable
    from dalle_pytorch_tpu_torch.serve.gateway import Gateway
    from dalle_pytorch_tpu_torch.serve.kv_pool import pages_for
    return Gateway(
        cells, cfg=cfg, model_version=GATEWAY_VERSION,
        tenants=None if tenants is None else TenantTable.from_json(tenants),
        max_prompt_len=cfg.text_seq_len,
        pages_per_request=pages_for(cfg.seq_len,
                                    GATEWAY_CELL["page_size"]),
        **kw).start()


def thread_cells(model, n: int = 2) -> list:
    from dalle_pytorch_tpu_torch.serve.server import InferenceServer
    return [InferenceServer(model, None, decode_images=False,
                            weights_version=GATEWAY_VERSION, device="cuda",
                            **GATEWAY_CELL).start() for _ in range(n)]


def affine_cell(gw, codes) -> int:
    """The cell index ``codes`` routes to while every cell has room."""
    from dalle_pytorch_tpu_torch.serve import prefix_cache as PC
    return gw._rank(PC.content_key(codes, cfg=gw.cfg,
                                   model_version=gw.model_version))[0]


def gateway_routing(model, affinity: bool) -> dict:
    """2 prompts x 5 waves, the order rotated each wave, through a fresh
    fleet of 2 thread cells: the fleet's prefix hits over completions."""
    cfg = model.cfg
    g = torch.Generator().manual_seed(21)
    prompts = [tuple(int(t) for t in torch.randint(
        1, cfg.num_text_tokens, (cfg.text_seq_len,), generator=g))
        for _ in range(2)]
    gw = gateway_over(thread_cells(model), cfg, GATEWAY_TENANTS_A,
                      affinity=affinity)
    try:
        for w in range(5):
            order = prompts if w % 2 == 0 else prompts[::-1]
            hs = [gw.submit(p, api_key="ks", seed=w,
                            image_seq_len_override=GATEWAY_ROUTE_GRID)
                  for p in order]
            for h in hs:
                res = h.result(timeout=GATEWAY_WAIT_S)
                check(res.ok, f"gateway: routing wave {w}: {res.status} "
                              f"{res.reason}")
        st = gw.stats()
        return {"hit_rate": st["fleet_prefix_hit_rate"],
                "prefix_hits": st["fleet"]["prefix_hits"],
                "completed": st["fleet"]["completed"],
                "routed": st["routed"], "spills": st["spills"]}, gw
    except BaseException:
        gw.close()
        raise


def gateway_reference(model, reqs) -> list:
    """Each request's tokens from ONE engine of a cell's shapes."""
    from dalle_pytorch_tpu_torch.serve import scheduler as S
    from dalle_pytorch_tpu_torch.serve.engine import Engine
    q = S.RequestQueue(max_depth=64)
    eng = Engine(model, q, device="cuda", **GATEWAY_CELL)
    handles = [q.submit(r) for r in reqs]
    eng.run_until_idle()
    out = []
    for h in handles:
        res = h.result(timeout=0)
        check(res.ok, f"gateway: reference {res.status} {res.reason}")
        out.append([int(t) for t in res.tokens])
    return out


def gateway_wave(gw, reqs, key: str) -> list:
    hs = [gw.submit(r.codes, api_key=key, seed=r.seed,
                    image_seq_len_override=r.image_seq_len_override)
          for r in reqs]
    return [h.result(timeout=GATEWAY_WAIT_S) for h in hs]


def tokens_of(results) -> list:
    return [[int(t) for t in r.tokens] if r.ok else r.status
            for r in results]


def gateway_cell_down(gw, reqs, want) -> dict:
    """Two requests of the busiest cell (and up to two of the other)
    decode first; then, armed by ``gateway_cell_down_at_request``, the
    next routed request kills the busiest cell, which holds them
    mid-stream; every flight it held replays on the survivor. Returns
    the counts and the seconds from the cell's death to the last
    replayed result."""
    from dalle_pytorch_tpu_torch.resilience import faults
    by_cell = {}
    for r, w in zip(reqs, want):
        by_cell.setdefault(affine_cell(gw, r.codes), []).append((r, w))
    order = sorted(by_cell, key=lambda c: -len(by_cell[c]))
    doomed = order[0]
    early = by_cell[doomed][:2] + (by_cell[order[1]][:2]
                                   if len(order) > 1 else [])
    late = by_cell[doomed][2:] + (by_cell[order[1]][2:]
                                  if len(order) > 1 else [])
    check(len(by_cell[doomed]) >= 3, f"gateway: {by_cell.keys()}")
    cell = gw.cells[doomed]
    base = cell.server.stats()["decode_steps"]
    downs, replays = gw.cell_downs, gw.replays
    done_at = {}
    with faults.injected(gateway_cell_down_at_request=gw.routed
                         + len(early) + 1):
        hs = [gw.submit(r.codes, api_key="ks", seed=r.seed,
                        image_seq_len_override=r.image_seq_len_override)
              for r, _ in early]
        wait_for("the doomed cell mid-stream", lambda: cell.server.stats()[
            "decode_steps"] >= base + 32, GATEWAY_WAIT_S, every=0.002)
        hs += [gw.submit(r.codes, api_key="ks", seed=r.seed,
                         image_seq_len_override=r.image_seq_len_override)
               for r, _ in late]
        deadline = time.perf_counter() + GATEWAY_WAIT_S
        while len(done_at) < len(hs):
            check(time.perf_counter() < deadline,
                  "gateway: the cell-down wave did not finish")
            for h in hs:
                if h.done() and h not in done_at:
                    done_at[h] = time.time()
            time.sleep(0.002)
    results = [h.result(timeout=0) for h in hs]
    check(tokens_of(results) == [w for _, w in early + late],
          "gateway: tokens through the cell down differ from the lone "
          "engine's")
    down = gw.events("gateway_cell_down")[-1]
    replayed = {e["request"] for e in gw.events("gateway_replay")}
    back = [t for h, t in done_at.items()
            if h.request.request_id in replayed]
    check(gw.cell_downs - downs == 1 and gw.replays - replays >= 1
          and back, f"gateway: cell_downs {gw.cell_downs}, replays "
                    f"{gw.replays}")
    return {"cell": down["cell"], "held": down["inflight"],
            "replays": gw.replays - replays,
            "cell_down_to_result_s": max(back) - down["time"]}


def gateway_thread_cells(model) -> dict:
    """A: routing with and without affinity; then, on the affinity
    fleet, 8 requests (256-token prompts, REPLICA_GRID image tokens),
    2 of them as a ``gold`` tenant with ``hedge_s`` 0, and 8 again
    through a cell down, each against a lone engine's tokens."""
    from dalle_pytorch_tpu_torch.ops import paged_attention as PA
    cfg = model.cfg
    reqs = replica_requests(cfg, 8, seed=60)
    t0 = time.perf_counter()
    want = gateway_reference(model, reqs)
    reference_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    PA.paged_decode_attention.launches = 0
    blind, gw = gateway_routing(model, affinity=False)
    gw.close()
    affine, gw = gateway_routing(model, affinity=True)
    try:
        check(affine["hit_rate"] > blind["hit_rate"],
              f"gateway: affinity's prefix-hit rate {affine['hit_rate']} "
              f"does not beat hash-blind's {blind['hit_rate']}")
        t0 = time.perf_counter()
        plain = gateway_wave(gw, reqs, "ks")
        wave_s = time.perf_counter() - t0
        check(tokens_of(plain) == want, "gateway: A's tokens differ from "
                                        "the lone engine's")
        hedged = gateway_wave(gw, reqs[:2], "kg")
        check(tokens_of(hedged) == want[:2] and gw.hedges >= 1,
              f"gateway: hedges {gw.hedges}, tokens "
              f"{tokens_of(hedged) == want[:2]}")
        down = gateway_cell_down(gw, reqs, want)
        st = gw.stats()
    finally:
        gw.close()
    k4 = PA.paged_decode_attention.launches
    check(k4 > 0, "gateway: K4 never launched in A's cells")
    return {"depth": cfg.depth, "dtype": "float32", **GATEWAY_CELL,
            "cells": 2, "grid": REPLICA_GRID, "affinity": affine,
            "hash_blind": blind, "wave_s": wave_s,
            "image_tokens_per_s": len(reqs) * REPLICA_GRID / wave_s,
            "reference_s": reference_s, "hedges": st["hedges"],
            "hedge_wins": st["hedge_wins"], "spills": st["spills"],
            "cell_down": down,
            "routed_by_cell": [c["routed"] for c in st["cells"]],
            "completed": st["completed"], "k4_launches": k4}


def gateway_call(port: int, path: str, body=None, token=None,
                 ready=None) -> tuple:
    """(status, JSON body, headers) of one call to the gateway's HTTP
    surface (``token`` as ``Authorization: Bearer``: an API key on
    /generate, the admin token on /admin/tenants). With ``ready`` (a
    barrier) the connection is opened first and the request sent once
    every party has reached it."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    if ready is not None:
        conn.connect()
        ready.wait(60)
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    conn.request("GET" if body is None else "POST", path,
                 body=None if body is None else json.dumps(body).encode(),
                 headers=headers)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    ctype = resp.getheader("Content-Type", "")
    return (resp.status, json.loads(raw) if "json" in ctype
            else raw.decode(), dict(resp.getheaders()))


def nearest_rank(xs, q: float) -> float:
    s = sorted(xs)
    return s[min(int(q * (len(s) - 1) + 0.5), len(s) - 1)]


def fleet_samples(text: str) -> dict:
    """The unlabeled sample of each federated family in /metrics."""
    from dalle_pytorch_tpu_torch.serve.gateway import _FEDERATED_COUNTERS
    out = {}
    for key, family in _FEDERATED_COUNTERS:
        for line in text.splitlines():
            if line.startswith(family + " "):
                out[key] = float(line.rsplit(" ", 1)[1])
    return out


def gateway_process_cells(model, vae, clip) -> dict:
    """B: the gateway's HTTP surface over 2 process cells (each a set of
    one child: the server spawns 2, one is removed), CLIP in each cell's
    parent worker. Warm-up, the victim alone, the victim under the
    ``tenant_flood`` row over HTTP (typed 429s), /metrics against the
    cells' stats, the admin reload; then image tokens/s over both cells
    and over one (the other closed), each child's ms a step."""
    import threading
    from dalle_pytorch_tpu_torch.ops import block_sparse as BS
    from dalle_pytorch_tpu_torch.resilience import faults
    from dalle_pytorch_tpu_torch.serve.gateway import make_gateway_http_server
    from dalle_pytorch_tpu_torch.serve.server import InferenceServer
    cfg = model.cfg
    size = cfg.vae.image_size
    t0 = time.perf_counter()
    cells = [InferenceServer(model, vae, clip=clip, replicas=2,
                             isolation="process", device="cuda",
                             weights_version=GATEWAY_VERSION,
                             **GATEWAY_CELL).start() for _ in range(2)]
    try:
        for srv in cells:
            wait_for("a cell's children READY",
                     lambda: process_ready(srv.engine), 600)
            srv.scale("remove", replica=1)
        check(all(srv.stats()["num_slots"] == GATEWAY_CELL["num_slots"]
                  for srv in cells), "gateway: a cell kept 2 children")
    except BaseException:
        for srv in cells:
            srv.close()
        raise
    bringup_s = time.perf_counter() - t0
    waits = {}
    holder = []

    def on_event(rec):
        # the gateway's added latency: submit -> dispatch, on its clock
        if rec.get("kind") == "gateway_route" and holder:
            fl = holder[0]._flights.get(rec["request"])
            if fl is not None:
                waits[rec["request"]] = \
                    fl.dispatch_t - fl.handle.request.submit_t
    gw = gateway_over(cells, cfg, GATEWAY_TENANTS_B, on_event=on_event,
                      admin_token=HTTP_TOKEN)
    holder.append(gw)
    httpd = make_gateway_http_server(gw, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    g = torch.Generator().manual_seed(23)
    # prompts by the cell they route to: 2 warm-up and 4 timed a cell
    by_cell = {0: [], 1: []}
    while len(by_cell[0]) < 6 or len(by_cell[1]) < 4:
        p = [int(t) for t in torch.randint(1, cfg.num_text_tokens,
                                           (cfg.text_seq_len,), generator=g)]
        by_cell[affine_cell(gw, p)].append(p)
    # the victim and the abuser share cell 0
    victim, abuser = by_cell[0][5], by_cell[0][4]
    answers = []

    def post(body, key, out=None, ready=None):
        ans = gateway_call(port, "/generate", body, key, ready)
        (answers if out is None else out).append(ans)
        return ans

    def ok(ans, grid) -> bool:
        code, body, _ = ans
        return (code == 200 and body["status"] == "ok"
                and len(body["tokens"]) == grid
                and body.get("clip_score") is not None
                and body["image_shape"] == [size, size, 3])

    def wave(prompts, key, grid):
        # every client connects first and all send at once, timed from
        # then (a connect past the listen backlog waits a SYN retransmit)
        out, sent = [], []
        go = threading.Barrier(len(prompts), action=lambda: sent.append(
            time.perf_counter()))
        threads = [threading.Thread(target=post, args=(
            {"codes": p, "seed": 50 + i, "image_seq_len_override": grid},
            key, out, go)) for i, p in enumerate(prompts)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(GATEWAY_WAIT_S)
        wall = time.perf_counter() - sent[0]
        check(len(out) == len(prompts) and all(ok(a, grid) for a in out),
              f"gateway: B wave {[a[0] for a in out]}")
        answers.extend(out)
        return wall

    def victim_round(tag, ready=None):
        lats, ids = [], []
        for i in range(6):
            t = time.perf_counter()
            ans = post({"codes": victim, "seed": i,
                        "image_seq_len_override": GATEWAY_VICTIM_GRID}, "kv",
                       ready=ready if i == 0 else None)
            if i == 0 and ready is not None:
                t = ready_t[-1]      # from the burst's release
            lats.append(time.perf_counter() - t)
            check(ok(ans, GATEWAY_VICTIM_GRID),
                  f"gateway: victim request dropped {tag}: {ans[:2]}")
            ids.append(ans[1]["request_id"])
            # the cell's own account of the request (admission to result)
            cell_s.setdefault(tag, []).append(ans[1]["total_s"])
        return lats, ids

    serving = [srv.engine.replicas[0] for srv in cells]
    cell_s, ready_t = {}, []
    BS.block_sparse_attention_fwd.launches = 0
    rec = {"bringup_s": bringup_s}
    try:
        wave(by_cell[0][:2] + by_cell[1][:2], "kv", PROCESS_WARM_GRID)
        check(ok(post({"codes": abuser, "seed": 0,
                       "image_seq_len_override": PROCESS_WARM_GRID}, "ka"),
                 PROCESS_WARM_GRID), "gateway: the abuser's warm-up failed")
        wait_for("the warm-up's last frames",
                 lambda: all(r.engine.active_slots() == 0 for r in serving),
                 60)
        alone, alone_ids = victim_round("alone")
        flood_out = []
        with faults.injected(tenant_flood="abuser",
                             tenant_flood_requests=GATEWAY_FLOOD):
            flood = faults.gateway_flood()
            check(flood == {"tenant": "abuser",
                            "requests": GATEWAY_FLOOD}, f"flood {flood}")
            # one burst: every abuser connection, and the victim's first,
            # is open before any sends, so the rps bucket (2 a second,
            # burst 2) admits its burst and no refill a slow start adds,
            # and no victim connect meets the burst's (the server listens
            # with a backlog of 5: a connect that finds it full waits out
            # a 1 s SYN retransmit)
            burst = threading.Barrier(flood["requests"] + 1, action=lambda:
                                      ready_t.append(time.perf_counter()))
            threads = [threading.Thread(target=post, args=(
                {"codes": abuser, "seed": 100 + i,
                 "image_seq_len_override": GATEWAY_VICTIM_GRID}, "ka",
                flood_out, burst)) for i in range(flood["requests"])]
            for th in threads:
                th.start()
            flooded, flooded_ids = victim_round("under the flood", burst)
            for th in threads:
                th.join(GATEWAY_WAIT_S)
        throttled = [a for a in flood_out if a[0] == 429]
        admitted = [a for a in flood_out if a[0] != 429]
        check(len(flood_out) == GATEWAY_FLOOD and throttled and all(
            a[1]["kind"] == "tenant_throttled" and a[1]["quota"] == "rps"
            and int(a[2]["Retry-After"]) >= 1 for a in throttled),
            f"gateway: the flood's answers {[a[0] for a in flood_out]}")
        check(all(ok(a, GATEWAY_VICTIM_GRID) for a in admitted),
              "gateway: an admitted abuser request did not complete")
        answers.extend(admitted)
        base_p95, flood_p95 = nearest_rank(alone, .95), \
            nearest_rank(flooded, .95)
        check(flood_p95 <= 1.5 * base_p95 + 0.25,
              f"gateway: the victim's p95 {flood_p95:.3f} s under the flood "
              f"over 1.5 x {base_p95:.3f} + 0.25 s; alone {alone}, "
              f"flooded {flooded}, in the cell {cell_s}")
        rec["flood"] = {
            "victim_alone_s": alone, "victim_flooded_s": flooded,
            "victim_cell_s": cell_s,
            "victim_alone_p50_s": nearest_rank(alone, .5),
            "victim_alone_p95_s": base_p95,
            "victim_flooded_p50_s": nearest_rank(flooded, .5),
            "victim_flooded_p95_s": flood_p95,
            "abuser_admitted": len(admitted),
            "abuser_throttled": len(throttled),
            "retry_after": sorted({a[2]["Retry-After"] for a in throttled}),
            "tenant_throttled": {k: v for k, v in throttled[0][1].items()
                                 if k != "time"}}
        victim_waits = [waits[i] * 1e3 for i in alone_ids + flooded_ids]
        rec["added_latency_ms"] = {"p50": nearest_rank(victim_waits, .5),
                                   "p99": nearest_rank(victim_waits, .99)}

        # image tokens/s over both cells, then over one
        timing = {}
        wait_for("the flood's last frames",
                 lambda: all(r.engine.active_slots() == 0 for r in serving),
                 60)
        four = by_cell[0][:4] + by_cell[1][:4]    # 4 clients a cell
        for n in (2, 1):
            live = serving[:n]
            before = [r.engine.decode_steps for r in live]
            wall, step_ms = child_step_ms(
                live, lambda: wave(four, "kv", REPLICA_HTTP_GRID),
                keys=[f"cell{i}" for i in range(n)])
            timing[n] = {
                "wall_s": wall,
                "decode_steps": [r.engine.decode_steps - b
                                 for r, b in zip(live, before)],
                "ms_per_decode_step": step_ms,
                "image_tokens_per_s": len(four) * REPLICA_HTTP_GRID / wall}
            if n == 2:
                code, text, _ = gateway_call(port, "/metrics")
                sums = {k: sum(int(srv.stats()[k]) for srv in cells)
                        for k in fleet_samples(text)}
                check(code == 200 and len(sums) == 4 and all(
                    fleet_samples(text)[k] == v for k, v in sums.items()),
                    f"gateway: /metrics {fleet_samples(text)} against the "
                    f"cells' stats {sums}")
                rec["fleet"] = sums
                reload = [dict(t) for t in GATEWAY_TENANTS_B]
                no_token = gateway_call(port, "/admin/tenants", reload)
                with_token = gateway_call(port, "/admin/tenants", reload,
                                          HTTP_TOKEN)
                check(no_token[0] == 401 and with_token[0] == 200
                      and with_token[1]["tenants"] == ["abuser", "victim"],
                      f"gateway: /admin/tenants {no_token[:2]} "
                      f"{with_token[:2]}")
                health = gateway_call(port, "/healthz")
                check(health[0] == 200
                      and health[1]["alive_cells"] == ["cell0", "cell1"],
                      f"gateway: /healthz {health[:2]}")
                k4 = {"cell1": cells[1].stats()["paged_decode_launches"]}
                cells[1].close()
                wait_for("the gateway to fence the closed cell",
                         lambda: gw.cell_downs == 1, 60)
        k4["cell0"] = cells[0].stats()["paged_decode_launches"]
        k3 = BS.block_sparse_attention_fwd.launches
        st = gw.stats()
        tenants = gw.tenants.stats()
    finally:
        httpd.shutdown()
        httpd.server_close()
        gw.close()
    per_score = clip.cfg.text_enc_depth + clip.cfg.visual_enc_depth
    check(k3 == per_score * len(answers), f"gateway: K3 launched {k3} "
          f"times for {len(answers)} CLIP scores, not {per_score} each")
    check(all(v > 0 for v in k4.values()), f"gateway: K4 {k4}")
    check(st["completed"] == len(answers) and st["cell_downs"] == 1,
          f"gateway: B stats completed {st['completed']}, answers "
          f"{len(answers)}, cell_downs {st['cell_downs']}")
    rec.update({
        "depth": cfg.depth, "dtype": str(model.text_emb.weight.dtype),
        **GATEWAY_CELL, "prompt_len": cfg.text_seq_len,
        "grid": REPLICA_HTTP_GRID, "clients": 8, "two_cells": timing[2],
        "one_cell": timing[1],
        "speedup": timing[2]["image_tokens_per_s"]
        / timing[1]["image_tokens_per_s"],
        "tenants": tenants, "completed": st["completed"],
        "k4_by_cell": k4, "k4_launches": sum(k4.values()),
        "k3_launches": k3})
    return rec


def phase_gateway() -> dict:
    """A (``gateway_thread_cells``, float32 thread cells) and B
    (``gateway_process_cells``, bfloat16 process cells, over HTTP), both
    at SERVE_DEPTH: K4 in every decode step of every cell, K3 in B's
    CLIP scores."""
    import dataclasses
    from dalle_pytorch_tpu_torch.models import clip as CL
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    cfg = dataclasses.replace(north_cfg(), depth=SERVE_DEPTH)
    record = {"phase": "gateway", "ok": True}
    t0 = time.perf_counter()
    model = D.dalle_init(cfg, seed=4, dtype=torch.float32)
    record["A"] = gateway_thread_cells(model)
    record["A"]["seconds"] = time.perf_counter() - t0
    emit(**record["A"], phase="gateway", part="A", ok=True)
    del model
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.bfloat16)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.bfloat16)
    clip = CL.clip_init(CL.CLIPConfig(sparse_impl="pallas"), seed=7,
                        dtype=torch.bfloat16)
    record["B"] = gateway_process_cells(model, vae, clip)
    record["B"]["seconds"] = time.perf_counter() - t0
    emit(**record["B"], phase="gateway", part="B", ok=True)
    record["k4_launches"] = record["A"]["k4_launches"] \
        + record["B"]["k4_launches"]
    record["k3_launches"] = record["B"]["k3_launches"]
    return record



# -- training across ranks ----------------------------------------------------

# the north config's heads; a tp 2 rank runs half of them
PARALLEL_CFG_HEADS = 8

# the parallel phase's runs: name, mesh, dense/sparse; all at the north
# width with ``train_cfg``'s kernels and dropout, depth cut to
# PARALLEL_DEPTH (pp: 2 stages of 2 layers, 4 microbatches)
PARALLEL_DEPTH = 4
PARALLEL_MICROBATCHES = 4
PARALLEL_RUNS = (("dp", {"dp": 2}, False), ("sp_ring", {"dp": 1, "sp": 2},
                                            False),
                 ("sp_ulysses", {"dp": 1, "sp": 2}, False),
                 ("pp", {"dp": 1, "pp": 2}, False),
                 ("pp_sparse", {"dp": 1, "pp": 2}, True),
                 ("tp", {"tp": 2}, False), ("tp_sparse", {"tp": 2}, True),
                 ("fsdp", {"fsdp": 2}, False), ("ep", {"ep": 2}, False))
# the placement of the runs whose parameters are split
# (``dalle_param_specs`` with ``mesh=``: the north vocabulary, 12,049
# tokens, is odd, so the head stays whole; ``dalle_moe_param_specs``)
PARALLEL_PLACE = {"tp": {"tp": "tp"}, "tp_sparse": {"tp": "tp"},
                  "fsdp": {"fsdp": "fsdp"}, "ep": {"ep": "ep"}}
# the ep run's MoE: every FF a top-2 MoE of 4 experts, 2 a rank
PARALLEL_MOE = dict(moe_experts=4, moe_k=2)
# generation over a dp-sharded candidate batch: 4 candidates of one
# caption over dp 2 at depth 2, float32 (the sampled tokens must be the
# one-process call's), then the CLIP rerank
GENERATE_DP = dict(dp=2, depth=2, candidates=4)
PARALLEL_WAIT_S = 300.0


def parallel_cfg(depth: int, sparse: bool, kind: str = ""):
    """``train_cfg`` at ``depth``; ``sparse`` alternates K3 layers with
    flash ones, (True, False) a stage at depth 4 (both layers sparse at
    depth 2, where (True, False) is not the same on both stages); the ep
    run's layers are MoE (``PARALLEL_MOE``)."""
    moe = PARALLEL_MOE if kind == "ep" else {}
    if not sparse:
        return train_cfg(depth=depth, **moe)
    pattern = (True, False) * (depth // 2) if depth >= 4 else (True,) * depth
    return train_cfg(depth=depth, sparse_attn=pattern, sparse_impl="pallas",
                     **moe)


def placement_specs(kind: str, model, mesh):
    """The run's ``param_specs`` on ``mesh``."""
    from dalle_pytorch_tpu_torch.parallel.train import (
        dalle_moe_param_specs, dalle_param_specs)
    place = PARALLEL_PLACE[kind]
    if "ep" in place:
        return dalle_moe_param_specs(model, place["ep"])
    return dalle_param_specs(model, mesh=mesh, **place)


def reckoned_bytes(kind: str, model) -> int:
    """The parameter bytes a rank of the run stores, reckoned from the
    whole model: tp 2 halves qkv, out, w1 (with its bias) and w2; fsdp 2
    half the layers; ep 2 half of each expert stack."""
    whole = split = 0
    for n, p in model.named_parameters():
        b = p.numel() * p.element_size()
        whole += b
        if kind.startswith("tp") and n.endswith((
                "qkv.weight", "out.weight", "ff.w1.weight", "ff.w1.bias",
                "ff.w2.weight")):
            split += b
        elif kind == "fsdp" and n.startswith("transformer.layers."):
            split += b
        elif kind == "ep" and n.endswith((".moe.w1", ".moe.w2")):
            split += b
    return whole - split // 2


def sequential_pp_loss(num_stages: int):
    """The loss ``pp_dalle_loss_fn`` computes over ``num_stages`` stages,
    in one process: the prompt embedded, the text mask extended over the
    image, then microbatch by microbatch (``PARALLEL_MICROBATCHES``)
    stage by stage, each stage's layers under ``fold_in(fold_in(rng,
    stage), m)``, and the loss of the hidden states. The one-process
    reference of a pipeline step (with dropout its keys are per stage,
    so it is not ``transformer_apply``); no MoE aux, which these runs'
    dense models do not have."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.ops import transformer as T
    from dalle_pytorch_tpu_torch.parallel.pipeline import stage_layers

    def loss(model, batch, rng):
        cfg = model.cfg.transformer
        text, ids = batch["text"], batch["image"]
        tokens = D.embed_prompt(model, text, ids)
        mask = torch.cat([batch["mask"].bool(),
                          torch.ones(ids.shape, dtype=torch.bool,
                                     device=ids.device)], dim=1)
        outs = []
        for m, (h, mk) in enumerate(zip(
                tokens.chunk(PARALLEL_MICROBATCHES),
                mask.chunk(PARALLEL_MICROBATCHES))):
            for s in range(num_stages):
                stage, stage_cfg = stage_layers(model.transformer, cfg,
                                                num_stages, s)
                h = T.transformer_apply(
                    stage, h, cfg=stage_cfg, mask=mk,
                    rng=prng.fold_in(prng.fold_in(rng, s), m), train=True)
            outs.append(h)
        return D.ce_from_hidden(model, torch.cat(outs), text, ids)

    return loss


def parallel_loss(kind: str, mesh, stages: int = 0):
    """The run's loss function and parameter placement on ``mesh``; on a
    one-rank mesh (the parent's reference) the same function in one
    process: ``sp`` at sp 1 (the masks are drawn per global position, the
    same at every degree), ``pp`` through ``sequential_pp_loss``."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.parallel.pipeline import (pp_dalle_loss_fn,
                                                           pp_param_specs)
    from dalle_pytorch_tpu_torch.parallel.sequence import sp_dalle_loss_fn
    if kind == "dp" or kind in PARALLEL_PLACE:
        def loss(model, batch, rng):
            return D.dalle_apply(model, batch["text"], batch["image"],
                                 mask=batch["mask"], rng=rng, train=True,
                                 return_loss=True)
        if kind == "dp":
            return loss, None
        return loss, lambda model: placement_specs(kind, model, mesh)
    if kind.startswith("sp_"):
        return sp_dalle_loss_fn(mesh, impl=kind[3:]), None
    if stages:
        return sequential_pp_loss(stages), None
    return (pp_dalle_loss_fn(mesh, num_microbatches=PARALLEL_MICROBATCHES),
            pp_param_specs)


class GradCapture:
    """An optimizer for ``make_train_step`` that takes the step's reduced
    gradients instead of applying them (no clip). Under a placement that
    splits parameters (``mesh``, ``specs``) each gradient is gathered
    whole from the ranks' pieces, on every rank of the pieces' groups."""
    clip = 0.0

    def __init__(self, model, mesh=None, specs=None):
        self.model, self.grads = model, {}
        self.mesh, self.specs = mesh, specs

    def step(self, lr_scale=1.0, grad_norm=None):
        from dalle_pytorch_tpu_torch.parallel import placement as PL
        if self.specs and self.mesh is not None:
            depth = len(self.model.transformer.layers)
            self.grads = {}
            for n, p in self.model.named_parameters():
                spec = PL.spec_of(self.specs, n)
                g = p.grad if p.grad is not None and not p.is_meta else \
                    torch.zeros(p.shape, dtype=p.dtype, device="cuda")
                self.grads[n] = PL.gather(g, n, spec, self.mesh,
                                          PL.owner(n, spec, self.mesh, depth))
        else:
            self.grads = {n: p.grad.detach().clone() for n, p in
                          self.model.named_parameters()
                          if not p.is_meta and p.grad is not None}
        for p in self.model.parameters():
            p.grad = None


def parallel_grads(kind, depth, sparse, dtype, mesh, stages=0) -> tuple:
    """(loss, {name: gradient}) of one step of the run from the seeded
    weights and key, through ``make_train_step`` (its reduction across the
    mesh), on this rank's rows of ``id_batch``."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.mesh import shard_batch
    from dalle_pytorch_tpu_torch.parallel.train import (make_train_step,
                                                         setup_sharded)
    cfg = parallel_cfg(depth, sparse, kind)
    model = D.dalle_init(cfg, seed=6, dtype=dtype)
    loss_fn, specs = parallel_loss(kind, mesh, stages)
    specs = specs(model) if specs else None
    cap = GradCapture(model, mesh, specs if kind in PARALLEL_PLACE else None)
    setup_sharded(model, cap_opt(model), mesh, specs)
    step = make_train_step(loss_fn, cap, mesh=mesh, param_specs=specs)
    batch = shard_batch(mesh, id_batch(cfg), "dp", local=False)
    loss = float(step(model, batch, prng.prng_key(5, device="cuda")))
    return loss, cap.grads


def cap_opt(model):
    """A throwaway optimizer for ``setup_sharded``'s placement."""
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer
    return make_optimizer(types.SimpleNamespace(
        lr=1e-4, lr_schedule="constant", warmup_steps=0, decay_steps=0,
        lr_end_ratio=0.1, n_epochs=1, clip_grad_norm=0.0),
        model.parameters())


def parallel_checks() -> list:
    """(name, kind, mesh, depth, sparse, dtype) of every comparison: each
    run at ``PARALLEL_DEPTH`` in bfloat16 and a depth-2 float32 copy."""
    out = []
    for kind, axes, sparse in PARALLEL_RUNS:
        loss_kind = "pp" if kind.startswith("pp") else kind
        out.append((kind, loss_kind, axes, PARALLEL_DEPTH, sparse,
                    "bfloat16"))
        out.append((f"{kind}/f32/depth2", loss_kind, axes, 2, sparse,
                    "float32"))
    return out


# the bf16 gradients held by their relative L2 error (2e-2) instead of
# their largest entry: the image's axial position embeddings, whose rows
# sum what the batch's positions scatter into them (each row from 32
# positions of every batch row), so their entries are differences of large
# partial sums and the bf16 rounding of each rank's sum shows against a
# small largest entry. dp 2 on an NVIDIA H100 80GB HBM3, 700.00 W, against
# the 2 % limit: rows 2.06 % of its largest entry, cols 2.09 % (every other
# gradient within it; relative L2 at most 0.0104)
BF16_SCATTERED = ("image_pos_rows.weight", "image_pos_cols.weight")


def grads_against(name, loss, grads, ref, dtype) -> dict:
    """The run's loss and every gradient it holds against the one-process
    reference: the loss relative, each gradient's largest error against
    its largest entry, float32 to 1e-5 and 1e-4, bfloat16 to
    ``train_grads_agree``'s 2e-2 and 2e-2 (``BF16_SCATTERED`` to their
    relative L2 error at 2e-2, both readings of each reported). Returns
    the record with ``failures`` (empty when every check holds)."""
    f32 = dtype == "float32"
    loss_rtol, grad_rtol = (1e-5, 1e-4) if f32 else (2e-2, 2e-2)
    failures = []
    if not (math.isfinite(loss) and abs(loss - ref["loss"])
            <= loss_rtol * abs(ref["loss"])):
        failures.append(f"parallel {name}: loss {loss} against one "
                        f"process {ref['loss']}")
    worst, worst_name, scattered = 0.0, None, {}
    for n, g in grads.items():
        want = ref["grads"][n].to(g.device).float()
        diff = g.float() - want
        of_largest = float(diff.abs().max()) / max(
            float(want.abs().max()), 1e-30)
        if not f32 and n in BF16_SCATTERED:
            l2 = float(diff.norm() / want.norm().clamp_min(1e-30))
            scattered[n] = {"of_largest": of_largest, "rel_l2": l2}
            ok, what = l2 <= grad_rtol, f"relative L2 {l2:.3e}"
        else:
            ok, what = of_largest <= grad_rtol, \
                f"{of_largest:.3e} of its largest entry"
            if of_largest >= worst:
                worst, worst_name = of_largest, n
        if not ok:
            failures.append(f"parallel {name}: grad {n} differs from one "
                            f"process by {what}")
    tolerance = {"loss_rtol": loss_rtol, "grad_of_largest": grad_rtol}
    if scattered:
        tolerance["rel_l2_of"] = {n: grad_rtol for n in scattered}
    return {"loss": loss, "one_process_loss": ref["loss"],
            "grads_held": len(grads), "max_grad_err_of_largest": worst,
            "worst_grad": worst_name, "scattered": scattered,
            "failures": failures, "tolerance": tolerance}


def parallel_rank(rank: int, plan: dict) -> dict:
    """One rank of the gloo pair on the card: every comparison against
    the parent's references, then each run's 2 steps (the first a
    warm-up) with its launches, ms, collectives and peak memory, then
    which gloo operations take CUDA tensors as they are."""
    import types
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel import collectives as col
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from dalle_pytorch_tpu_torch.parallel.train import (make_train_step,
                                                         setup_sharded)
    out = {"compare": {}, "runs": {}, "gloo_cuda": gloo_cuda_check()}
    for name, kind, axes, depth, sparse, dtype in parallel_checks():
        mesh = make_mesh(axes)
        ref = torch.load(os.path.join(plan["refs"], name.replace("/", "_")
                                      + ".pt"))
        loss, grads = parallel_grads(kind, depth, sparse,
                                     getattr(torch, dtype), mesh)
        out["compare"][name] = grads_against(name, loss, grads, ref, dtype)
        del ref, grads
        torch.cuda.empty_cache()
    for kind, axes, sparse in PARALLEL_RUNS:
        mesh = make_mesh(axes)
        cfg = parallel_cfg(PARALLEL_DEPTH, sparse, kind)
        model = D.dalle_init(cfg, seed=6, dtype=torch.bfloat16)
        whole_bytes = resident_bytes(model)
        reckoned = reckoned_bytes(kind, model) if kind in PARALLEL_PLACE \
            else None
        loss_fn, specs = parallel_loss(kind, mesh)
        specs = specs(model) if specs else None
        opt = make_optimizer(types.SimpleNamespace(
            lr=1e-4, lr_schedule="constant", warmup_steps=0, decay_steps=0,
            lr_end_ratio=0.1, n_epochs=1, clip_grad_norm=0.0),
            model.parameters())
        setup_sharded(model, opt, mesh, specs)
        step = make_train_step(loss_fn, opt, mesh=mesh, param_specs=specs)
        batch = shard_batch(mesh, id_batch(cfg), "dp", local=False)
        root = prng.prng_key(0, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sparse_counts(reset=True)
        losses = [float(step(model, batch, prng.fold_in(root, 0)))]
        torch.cuda.synchronize()
        col.reset_stats()
        t0 = time.perf_counter()
        losses.append(float(step(model, batch, prng.fold_in(root, 1))))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out["runs"][kind] = {
            "losses": losses, "ms_per_step": ms,
            "launches": sparse_counts(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "param_gib": resident_bytes(model) / 2 ** 30,
            "param_bytes": resident_bytes(model),
            "replicated_param_bytes": whole_bytes,
            "reckoned_param_bytes": reckoned,
            "heads_per_rank": model.transformer.layers[0].attn.qkv.weight
                                   .shape[0] // (3 * cfg.dim_head),
            "collectives": {"host_ms_per_step": col.STATS["host_ms"],
                            "bytes_per_step": col.STATS["bytes"],
                            "calls_per_step": dict(col.STATS["calls"]),
                            "staged_through_host":
                                sorted(col.STATS["staged"])}}
        del model, opt, step
        torch.cuda.empty_cache()
    out["generate_dp"] = generate_dp_rank(plan)
    return out


def resident_bytes(model) -> int:
    """The bytes of the parameters this rank stores (not on meta)."""
    return sum(p.numel() * p.element_size() for p in model.parameters()
               if not p.is_meta)


def generate_dp_setup():
    """The generate_dp run's float32 DALLE (``GENERATE_DP``'s depth), VAE,
    CLIP (K3 non-causal) and candidate batch (one caption, its rows),
    from seeds."""
    from dalle_pytorch_tpu_torch.models import clip as CL
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.models import vae as V
    cfg = parallel_cfg(GENERATE_DP["depth"], False)
    vae = V.vae_init(cfg.vae, seed=3, dtype=torch.float32)
    model = D.dalle_init(cfg, seed=4, vae=vae, dtype=torch.float32)
    clip = CL.clip_init(CL.CLIPConfig(sparse_impl="pallas"), seed=7,
                        dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(11)
    caption = torch.randint(1, cfg.num_text_tokens, (1, cfg.text_seq_len),
                            generator=g, device="cuda")
    text = caption.repeat(GENERATE_DP["candidates"], 1)
    return model, vae, clip, text


def generate_dp_run(mesh=None) -> dict:
    """``generate_images`` of the candidates on ``mesh`` (one process:
    None), twice: with ``clip=`` (the images and the CLIP rerank's
    scores, gathered; on a mesh each rank scores its own rows), its K3
    launches counted from just before the call, then with
    ``return_img_seq=True`` for the image ids."""
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    model, vae, clip, text = generate_dp_setup()
    key = prng.prng_key(13, device="cuda")
    t0 = time.perf_counter()
    sparse_counts(reset=True)
    images, scores = D.generate_images(model, vae, text, rng=key, clip=clip,
                                       mesh=mesh)
    torch.cuda.synchronize()
    k3 = sparse_counts()["k3"]
    seconds = time.perf_counter() - t0
    _, ids = D.generate_images(model, vae, text, rng=key,
                               return_img_seq=True, mesh=mesh)
    return {"ids": ids.cpu(), "images": images.cpu(), "scores": scores.cpu(),
            "k3": k3, "seconds": seconds}


def generate_dp_rank(plan: dict) -> dict:
    """This rank's part of generate_dp: the candidates over dp 2, held
    against the one-process calls: the image ids identical, the images
    and the rerank's scores to 1e-4, its order the same. The rank's
    rerank is one ``clip_apply`` over its rows, so it launches K3 as
    often as the one process's over all of them (each sparse layer
    once)."""
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    ref = torch.load(os.path.join(plan["refs"], "generate_dp.pt"))
    got = generate_dp_run(make_mesh({"dp": GENERATE_DP["dp"]}))
    diff = int((got["ids"] != ref["ids"]).sum())
    img_err = float((got["images"] - ref["images"]).abs().max())
    score_err = float((got["scores"] - ref["scores"]).abs().max())
    order = torch.argsort(got["scores"], descending=True).tolist()
    want_order = torch.argsort(ref["scores"], descending=True).tolist()
    failures = []
    if diff:
        failures.append(f"generate_dp: {diff} image ids differ from one "
                        "process")
    if not img_err <= 1e-4 or not score_err <= 1e-4 or order != want_order:
        failures.append(f"generate_dp: images {img_err:.3e}, scores "
                        f"{score_err:.3e} from one process, order {order} "
                        f"against {want_order}")
    return {"ids_differing": diff, "images_max_abs_err": img_err,
            "scores_max_abs_err": score_err, "order": order,
            "k3_launches": got["k3"], "one_process_k3": ref["k3"],
            "seconds": got["seconds"], "one_process_seconds": ref["seconds"],
            "failures": failures,
            "tolerance": {"ids": "identical", "images_atol": 1e-4,
                          "scores_atol": 1e-4}}


def gloo_cuda_check() -> dict:
    """The collectives on CUDA tensors over the gloo pair, each against the
    values it must give: those gloo runs on the device pointers
    (``collectives.GLOO_CUDA``: psum, broadcast, all_gather and its
    reduce_scatter transpose, all_to_all, a bfloat16 gather) and the
    ppermute it stages through the host (gloo's send and receive of a
    device pointer end the process with ``writev: Bad address``, PR 19
    call 3). Returns {operation: held} and the staged operations."""
    from dalle_pytorch_tpu_torch.parallel import collectives as col
    g = col.world()
    n, r = g.size, g.index
    base = torch.arange(6.0, device="cuda").reshape(2, 3)
    x = base + 10 * r
    held = {"all_reduce": bool((col.psum(x, g) == n * base + 10 * sum(
        range(n))).all()),
        "broadcast": bool((col.broadcast(x, g, 0) == base).all())}
    xg = x.clone().requires_grad_()
    y = col.all_gather(xg, g, dim=0)
    (y * (r + 1)).sum().backward()
    held["all_gather"] = bool((y == torch.cat(
        [base + 10 * i for i in range(n)])).all())
    held["reduce_scatter"] = bool((xg.grad == sum(range(1, n + 1))).all())
    z = torch.arange(n * 2 * 3.0, device="cuda").reshape(n * 2, 3) + 100 * r
    want = torch.cat([(torch.arange(n * 2 * 3.0, device="cuda").reshape(
        n * 2, 3) + 100 * i)[r * 2:(r + 1) * 2] for i in range(n)], dim=1)
    held["all_to_all"] = bool((col.all_to_all(z, g, 0, 1) == want).all())
    held["ppermute"] = bool((col.ppermute(x, g) == base + 10 * (
        (r - 1) % n)).all())
    b16 = torch.tensor([1.5, -2.25, r], dtype=torch.bfloat16, device="cuda")
    held["bfloat16_gather"] = bool((col.all_gather(b16, g).float().cpu() ==
                                    torch.tensor([v for i in range(n) for v
                                                  in (1.5, -2.25, i)])
                                    ).all())
    return {"held": held, "staged": sorted(col.STATS["staged"])}


def nccl_rank(rank: int, plan: dict) -> dict:
    """The one-rank NCCL group: the dp step of the bfloat16 run (a mesh of
    one), then each collective the port uses, on CUDA tensors through
    NCCL itself."""
    import torch.distributed as dist
    from dalle_pytorch_tpu_torch.parallel import multihost
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    check(multihost.backend() == "nccl", "nccl rank: backend "
                                         f"{multihost.backend()}")
    mesh = make_mesh({"dp": 1})
    ref = torch.load(os.path.join(plan["refs"], "dp.pt"))
    sparse_counts(reset=True)
    loss, grads = parallel_grads("dp", PARALLEL_DEPTH, False,
                                 torch.bfloat16, mesh)
    out = {"compare": grads_against("nccl/dp", loss, grads, ref,
                                    "bfloat16"),
           "launches": sparse_counts()}
    check(not out["compare"]["failures"], str(out["compare"]["failures"]))
    x = torch.arange(8.0, device="cuda")
    ops = {}
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty_like(x), x)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty_like(x), x)),
            ("all_to_all_single", lambda: dist.all_to_all_single(
                torch.empty_like(x), x)),
            ("broadcast", lambda: dist.broadcast(x.clone(), src=0))):
        fn()
        torch.cuda.synchronize()
        ops[name] = "ok"
    out["ops"] = ops
    return out


def nccl_pair_rank(rank: int) -> str:
    """Two NCCL ranks on the one card: the first collective's outcome."""
    import torch.distributed as dist
    try:
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        return f"ran: {float(x[0])}"
    except Exception as e:                      # noqa: BLE001 — reported
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def parallel_references(root: str) -> dict:
    """The one-process step of every comparison, in this process on the
    card, saved under ``root`` for the ranks; returns its losses."""
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    one = make_mesh({"dp": 1, "sp": 1})
    losses = {}
    for name, kind, _, depth, sparse, dtype in parallel_checks():
        loss, grads = parallel_grads(kind, depth, sparse,
                                     getattr(torch, dtype), one, stages=2)
        torch.save({"loss": loss, "grads": {n: g.cpu() for n, g in
                                            grads.items()}},
                   os.path.join(root, name.replace("/", "_") + ".pt"))
        losses[name] = loss
        del grads
        torch.cuda.empty_cache()
    torch.save(generate_dp_run(), os.path.join(root, "generate_dp.pt"))
    torch.cuda.empty_cache()
    return losses


def parallel_cli(root: str) -> dict:
    """``train_dalle --sp 2`` as two processes on the card for one epoch
    over the ``cli`` phase's 16 PNGs and VAE (``CLI_DALLE`` at
    ``PARALLEL_DEPTH``): rank 0 writes the checkpoint once (no staging
    residue) and rank 1 writes nothing; then this process resumes it for
    one more epoch."""
    from dalle_pytorch_tpu_torch.cli import train_dalle
    from dalle_pytorch_tpu_torch.parallel.launch import free_port
    dalle = list(CLI_DALLE)
    dalle[dalle.index("--depth") + 1] = str(PARALLEL_DEPTH)
    base = ["--dataPath", os.path.join(root, "imagedata"), "--batchSize",
            "8", "--log_interval", "1", "--seed", "3"] + dalle + [
        "--captions_only",
        os.path.join(root, "only.txt"), "--captions",
        os.path.join(root, "pairs.txt"), "--name", "spcli",
        "--models_dir", os.path.join(root, "b", "models")]
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs, logs = [], []
    t0 = time.perf_counter()
    for i in range(2):
        log = open(os.path.join(root, f"sp_rank{i}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dalle_pytorch_tpu_torch.cli.train_dalle"]
            + base + ["--n_epochs", "1", "--sp", "2", "--sp_impl", "ring",
                      "--num_processes", "2", "--process_id", str(i),
                      "--coordinator", f"127.0.0.1:{port}",
                      "--results_dir", os.path.join(root, f"sp{i}", "res"),
                      "--metrics", os.path.join(root, f"sp{i}", "m.jsonl")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=PARALLEL_WAIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t0
    tails = {}
    for i in range(2):
        with open(os.path.join(root, f"sp_rank{i}.log")) as f:
            tails[i] = f.read()[-1500:]
    check(rcs == [0, 0], f"parallel cli: ranks exited {rcs}: {tails}")
    models = os.path.join(root, "b", "models")
    check(os.path.isdir(os.path.join(models, "spcli_dalle-0")),
          f"parallel cli: no checkpoint in {sorted(os.listdir(models))}")
    residue = [d for d in os.listdir(models) if d.startswith(".ckpt-")]
    check(not residue, f"parallel cli: staging residue {residue}")
    check(not os.path.exists(os.path.join(root, "sp1")),
          "parallel cli: rank 1 wrote its results or metrics")
    with open(os.path.join(root, "sp0", "m.jsonl")) as f:
        sp_losses = [json.loads(x)["loss"] for x in f if '"loss"' in x]
    t1 = time.perf_counter()
    train_dalle.main(base + ["--n_epochs", "1", "--load_dalle", "spcli",
                             "--results_dir", os.path.join(root, "r"),
                             "--metrics", os.path.join(root, "r.jsonl")])
    resume_s = time.perf_counter() - t1
    with open(os.path.join(root, "r.jsonl")) as f:
        resumed = [json.loads(x)["loss"] for x in f if '"loss"' in x]
    check(os.path.isdir(os.path.join(models, "spcli_dalle-1")) and resumed
          and all(math.isfinite(x) for x in resumed),
          f"parallel cli: the one-process resume gave {resumed}")
    return {"two_rank_wall_s": wall, "sp_losses": sp_losses,
            "resumed_losses": resumed, "resume_wall_s": resume_s}


def parallel_single_ms() -> dict:
    """ms a step of each run's one-process step in this process (Adam, 2
    steps on the whole batch, the first a warm-up)."""
    import types
    from dalle_pytorch_tpu_torch.cli.common import make_optimizer
    from dalle_pytorch_tpu_torch.models import dalle as D
    from dalle_pytorch_tpu_torch.ops import prng
    from dalle_pytorch_tpu_torch.parallel.mesh import make_mesh
    from dalle_pytorch_tpu_torch.parallel.train import make_train_step
    one = make_mesh({"dp": 1, "sp": 1})
    out = {}
    for kind, _, sparse in PARALLEL_RUNS:
        cfg = parallel_cfg(PARALLEL_DEPTH, sparse, kind)
        model = D.dalle_init(cfg, seed=6, dtype=torch.bfloat16)
        loss_fn, specs = parallel_loss(
            "pp" if kind.startswith("pp") else kind, one, stages=2)
        opt = make_optimizer(types.SimpleNamespace(
            lr=1e-4, lr_schedule="constant", warmup_steps=0, decay_steps=0,
            lr_end_ratio=0.1, n_epochs=1, clip_grad_norm=0.0),
            model.parameters())
        step = make_train_step(loss_fn, opt, mesh=one,
                               param_specs=specs(model) if specs else None)
        batch = id_batch(cfg)
        root = prng.prng_key(0, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        step(model, batch, prng.fold_in(root, 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, batch, prng.fold_in(root, 1))
        torch.cuda.synchronize()
        out[kind] = {"ms_per_step": (time.perf_counter() - t0) * 1e3,
                     "peak_mem_gib":
                         torch.cuda.max_memory_allocated() / 2 ** 30}
        del model, opt, step
        torch.cuda.empty_cache()
    return out


def parallel_tp_kernels() -> dict:
    """K1, K2a, K2b and K3 at the shapes a tp 2 rank gives them (its 4 of
    the 8 heads, the whole batch), and K3 without the causal constraint at
    the shape of a generate_dp rank's rerank (float32, its rows, the CLIP
    text encoder's 8 heads of 64 over 256 positions), against their plain
    versions, timed."""
    return {
        "flash": flash_case(torch.bfloat16, False, timed=True,
                            h=PARALLEL_CFG_HEADS // 2),
        "k3": sparse_case(torch.bfloat16, False, timed=True,
                          h=PARALLEL_CFG_HEADS // 2),
        "k3_rerank": sparse_case(
            torch.float32, False, timed=True, causal=False,
            b=GENERATE_DP["candidates"] // GENERATE_DP["dp"], h=8,
            n=256, d=64)}


def phase_parallel(cli_root: str = "", tp_kernels: dict = None) -> dict:
    """Training across ranks on the one card: K1-K3 were built by
    ``build``, here, before any rank spawns. The one-process reference of
    every comparison (generate_dp's too) and each run's one-process ms a
    step first, then K1-K3 at a tp rank's shapes (``parallel_tp_kernels``,
    in this process, or taken from ``tp_kernels``), then two
    spawned rank processes over gloo (each its own CUDA context on the
    same card: the collectives' values on CUDA tensors, every comparison,
    each run's 2 steps, generate_dp), then ``parallel_cli`` with,
    beside it, a one-rank NCCL group (the dp comparison and each NCCL
    collective) and two NCCL ranks on the one card (NCCL's answer
    recorded)."""
    import shutil
    import tempfile
    from dalle_pytorch_tpu_torch.parallel.launch import spawn
    refs = tempfile.mkdtemp(prefix="chip-smoke-par-")
    record = dict(phase="parallel", ok=True, depth=PARALLEL_DEPTH,
                  microbatches=PARALLEL_MICROBATCHES)
    try:
        t0 = time.perf_counter()
        record["one_process_losses"] = parallel_references(refs)
        record["references_s"] = time.perf_counter() - t0
        # the one-process step's ms at the same shapes: the two ranks
        # share the one card, so their ratio is no speedup
        t0 = time.perf_counter()
        record["one_process"] = parallel_single_ms()
        record["one_process_s"] = time.perf_counter() - t0
        # the kernels at a tp rank's shapes: timed here unless the caller
        # timed them alone (``tp_kernels``, the default run's first stream)
        t0 = time.perf_counter()
        record["tp_kernels"] = tp_kernels or parallel_tp_kernels()
        record["tp_kernels_s"] = time.perf_counter() - t0
        plan = {"refs": refs}
        t0 = time.perf_counter()
        ranks = spawn(parallel_rank, 2, (plan,), device=None,
                      backend="gloo", timeout_s=PARALLEL_WAIT_S,
                      group_timeout_s=120.0, threads=4)
        record["gloo_pair_s"] = time.perf_counter() - t0
        record["compare"] = {r: ranks[r]["compare"] for r in range(2)}
        failures = [f for r in range(2) for c in ranks[r]["compare"].values()
                    for f in c["failures"]]
        record["runs"] = {r: ranks[r]["runs"] for r in range(2)}
        steps = 2
        launches = {}
        for kind, axes, sparse in PARALLEL_RUNS:
            got = [ranks[r]["runs"][kind]["launches"] for r in range(2)]
            if kind.startswith("sp"):
                want_dense, want_sparse = 0, 0
            elif kind in ("dp", "tp", "fsdp", "ep"):
                want_dense, want_sparse = PARALLEL_DEPTH * steps, 0
            elif kind == "tp_sparse":
                n_sparse = PARALLEL_DEPTH // 2
                want_dense = (PARALLEL_DEPTH - n_sparse) * steps
                want_sparse = n_sparse * steps
            else:
                per = PARALLEL_DEPTH // 2
                n_sparse = per // 2 if sparse else 0
                want_dense = (per - n_sparse) * PARALLEL_MICROBATCHES * steps
                want_sparse = n_sparse * PARALLEL_MICROBATCHES * steps
            for r, counts in enumerate(got):
                check(counts["k3"] == want_sparse and all(
                    counts[k] == want_dense for k in ("k1", "k2a", "k2b")),
                    f"parallel {kind}: rank {r} launched {counts}, expected "
                    f"K1/K2a/K2b {want_dense} and K3 {want_sparse} each")
            launches[kind] = got
            if kind in PARALLEL_PLACE:
                for r in range(2):
                    run = ranks[r]["runs"][kind]
                    heads = run["heads_per_rank"]
                    check(heads == (PARALLEL_CFG_HEADS // 2 if
                                    kind.startswith("tp")
                                    else PARALLEL_CFG_HEADS),
                          f"parallel {kind}: rank {r} ran {heads} heads")
                    check(run["param_bytes"] == run["reckoned_param_bytes"]
                          < run["replicated_param_bytes"],
                          f"parallel {kind}: rank {r} stores "
                          f"{run['param_bytes']} parameter bytes, reckoned "
                          f"{run['reckoned_param_bytes']} of "
                          f"{run['replicated_param_bytes']}")
        record["launches"] = launches
        record["param_bytes"] = {
            kind: {"ranks": [ranks[r]["runs"][kind]["param_bytes"]
                             for r in range(2)],
                   "replicated": ranks[0]["runs"][kind][
                       "replicated_param_bytes"]}
            for kind, _, _ in PARALLEL_RUNS}
        gen = [ranks[r]["generate_dp"] for r in range(2)]
        record["generate_dp"] = gen
        failures += [f for g in gen for f in g["failures"]]
        for r, g in enumerate(gen):
            check(g["k3_launches"] == g["one_process_k3"] > 0,
                  f"parallel generate_dp: rank {r} launched K3 "
                  f"{g['k3_launches']} times, one process "
                  f"{g['one_process_k3']}")
        if failures:
            emit(**record)
        check(not failures, "; ".join(failures))
        gloo = ranks[0]["gloo_cuda"]
        record["gloo_cuda"] = gloo
        check(all(gloo["held"].values()) and gloo["staged"] == ["ppermute"],
              f"parallel: gloo on CUDA tensors {gloo}")
        # the NCCL checks start no timing of their own: they run beside the
        # CLI's two ranks, in threads that each wait on their spawn
        pool = concurrent.futures.ThreadPoolExecutor(2)
        t0 = time.perf_counter()
        one = pool.submit(spawn, nccl_rank, 1, (plan,), device=None,
                          backend="nccl", timeout_s=150.0,
                          group_timeout_s=60.0, threads=4)

        def pair():
            try:
                return spawn(nccl_pair_rank, 2, device=None, backend="nccl",
                             timeout_s=90.0, group_timeout_s=30.0)
            except (RuntimeError, TimeoutError) as e:
                return f"{type(e).__name__}: {str(e)[-400:]}"

        two = pool.submit(pair)
        if cli_root:
            record["cli"] = parallel_cli(cli_root)
        (nccl,) = one.result()
        record["nccl_one_rank"] = nccl
        record["nccl_two_ranks_one_card"] = two.result()
        record["nccl_and_cli_s"] = time.perf_counter() - t0
        pool.shutdown()
        check(nccl["launches"]["k1"] == PARALLEL_DEPTH,
              f"parallel nccl: launches {nccl['launches']}")
    finally:
        shutil.rmtree(refs, ignore_errors=True)
        if cli_root:
            shutil.rmtree(cli_root, ignore_errors=True)
    emit(**record)
    return record

ONLY = {"images": phase_images, "generate": phase_generate,
        "replicas": phase_replicas, "processes": phase_processes,
        "gateway": phase_gateway, "cli": phase_cli,
        "parallel": phase_parallel, "http": phase_http,
        "serve_features": phase_serve_features, "import": phase_import,
        "mesh": phase_mesh, "rev_decode": phase_rev_decode}

# the phases that the default run's second process (``--stream``) runs,
# in this order, beside the first process's serving phases: each starts
# processes of its own or gates no time; ``STREAM_WAIT_S`` is how long
# the first process waits for it once its own phases are done
STREAM = ("cli", "parallel", "replicas", "processes", "import", "mesh",
          "rev_decode")
STREAM_WAIT_S = 900.0


def run_phases(names, train: dict = None, tp_kernels: dict = None) -> dict:
    """The ``ONLY`` phases ``names``, one after another in this process:
    cli keeps its data and VAE for parallel's CLI run where both run,
    and processes compares its pair with replicas' of the same call."""
    done = {}
    for name in names:
        args = ()
        if name == "processes":
            args = (done.get("replicas"),)
        elif name == "cli":
            args = (train, "parallel" in names)
        elif name == "parallel":
            args = ((done.get("cli") or {}).get("root", ""), tp_kernels)
        done[name] = timed(ONLY[name], *args)
    return done


class Stream:
    """The default run's second stream: ``chip_smoke.py --stream DIR`` in
    a session of its own, its records and phase seconds back through
    DIR/records.json and its printed records through DIR/stdout."""

    def __init__(self, context: dict):
        import tempfile
        self.dir = tempfile.mkdtemp(prefix="chip-smoke-stream-")
        with open(os.path.join(self.dir, "context.json"), "w") as f:
            json.dump({**context, "parent": os.getpid()}, f)
        self.log = open(os.path.join(self.dir, "stdout"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--stream",
             self.dir], cwd=ROOT, stdout=self.log, start_new_session=True)

    def echo(self) -> None:
        """Print what the stream printed (once)."""
        if self.log.closed:
            return
        self.log.close()
        with open(os.path.join(self.dir, "stdout")) as f:
            sys.stdout.write(f.read())
        sys.stdout.flush()

    def poll(self) -> None:
        """Fail now where the stream has already failed."""
        rc = self.proc.poll()
        if rc not in (None, 0):
            self.echo()
            check(False, f"stream: {' '.join(STREAM)} exited {rc}")

    def join(self) -> dict:
        """Wait for the stream: {"records": {phase: record},
        "phase_seconds": ...}."""
        try:
            rc = self.proc.wait(timeout=STREAM_WAIT_S)
        except subprocess.TimeoutExpired:
            rc = f"nothing: still running after {STREAM_WAIT_S} s"
        self.echo()
        check(rc == 0, f"stream: {' '.join(STREAM)} exited {rc}")
        with open(os.path.join(self.dir, "records.json")) as f:
            return json.load(f)

    def close(self) -> None:
        """Stop the stream, then every process left in its session."""
        import shutil
        import signal
        if self.proc.poll() is None:
            # SIGTERM: its phases' finally blocks close their children
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait()
        self.echo()
        shutil.rmtree(self.dir, ignore_errors=True)


def stream_main(path: str) -> int:
    """``--stream DIR``: ``STREAM`` for the default run's first process,
    which wrote DIR/context.json (its pid, the train phase's ms a step,
    the kernels timed at a tp rank's shapes); the records go to
    DIR/records.json. The stream ends with the first process: SIGTERM
    when it dies, and SIGTERM exits through the phases' finally
    blocks."""
    import ctypes
    import signal
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    ctypes.CDLL(None).prctl(1, int(signal.SIGTERM))     # PR_SET_PDEATHSIG
    with open(os.path.join(path, "context.json")) as f:
        ctx = json.load(f)
    if os.getppid() != ctx["parent"]:
        return 1
    done = run_phases(STREAM, train=ctx["train"],
                      tp_kernels=ctx["tp_kernels"])
    with open(os.path.join(path, "records.json"), "w") as f:
        json.dump({"records": done, "phase_seconds": PHASE_SECONDS}, f,
                  default=str)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if len(sys.argv) == 3 and sys.argv[1] == "--stream":
        return stream_main(sys.argv[2])
    if len(sys.argv) > 1:
        # ``--only a,b``: build, then those phases alone (no kernel table)
        if len(sys.argv) != 3 or sys.argv[1] != "--only" or not set(
                sys.argv[2].split(",")) <= set(ONLY):
            print(f"usage: chip_smoke.py [--only {','.join(ONLY)}]",
                  file=sys.stderr)
            return 2
        card = timed(phase_build)
        run_phases(sys.argv[2].split(","))
        emit(phase_seconds=PHASE_SECONDS)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    t_start = time.perf_counter()
    # the kernels and the training steps, alone on the card
    card = timed(phase_build)
    timed(phase_images)
    kernel = timed(phase_kernel)
    timed(phase_decode)
    flash = timed(phase_flash)
    train = timed(phase_train)
    wide_train = timed(phase_wide_train)
    fused_train = timed(phase_fused_train)
    sparse = timed(phase_sparse_kernels)
    sparse_train = timed(phase_sparse_train)
    wide_sparse_train = timed(phase_wide_sparse_train)
    timed(phase_vae_train)
    rev_train = timed(phase_rev_train)
    moe_train = timed(phase_moe_train)
    clip_train = timed(phase_clip_train)
    remat = timed(phase_remat)
    tp_kernels = timed(parallel_tp_kernels)
    # then the serving phases here, beside ``STREAM`` in a second process
    stream = Stream({"train": {"ms_per_step": train["ms_per_step"]},
                     "tp_kernels": tp_kernels})
    t_streams = time.perf_counter()
    try:
        serving = []
        for phase in (phase_engine, phase_sparse_engine, phase_wide_engine,
                      phase_generate, phase_serve_features, phase_http,
                      phase_gateway):
            serving.append(timed(phase))
            stream.poll()
        first_done = time.perf_counter() - t_streams
        got = stream.join()
    finally:
        stream.close()
    engine, sparse_engine, wide_engine, generate, features, served, \
        gateway = serving
    cli, parallel, fleet, procs, mesh, rev_decode = (
        got["records"][name] for name in ("cli", "parallel", "replicas",
                                          "processes", "mesh", "rev_decode"))
    emit(phase_seconds=PHASE_SECONDS,
         stream_phase_seconds=got["phase_seconds"],
         total_seconds=sum(PHASE_SECONDS.values())
         + sum(got["phase_seconds"].values()),
         streams_s={"first": first_done,
                    "both": time.perf_counter() - t_streams},
         wall_seconds=time.perf_counter() - t_start)
    main_case = kernel["bfloat16"]
    rows = [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": engine["k4_launches"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": None}]
    # the flash kernels at the training main path's case: bfloat16, the
    # all-True mask; K2b as the split mode the main path launches
    fc = flash["bfloat16/all_true"]
    lib = fc["library"]
    for name, kind, line, count, library_ms in (
            ("flash_attention_fwd", "fwd", 88, "k1", lib["sdpa_fwd_ms"]),
            ("flash_attention_bwd_dq", "dq", 322, "k2a", None),
            ("flash_attention_bwd_dkv", "dkv", 367, "k2b",
             lib["sdpa_bwd_ms"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"dalle_pytorch_tpu/ops/flash_attention.py:{line}",
            "launches": train["launches"][count],
            "max_abs_err": fc["max_abs_err"][kind],
            "ms": fc[kind]["ms"], "plain_ms": fc[kind]["plain_ms"],
            "bound_ms": fc[kind]["bound_ms"],
            "bound_by": fc[kind]["bound_by"], "library_ms": library_ms})
    # the wide bodies at the wide_train path's case (bfloat16, all-True
    # mask, b 8, h 2, n 1280, d 256): K1, K2a and K2b split on the tensor
    # cores
    wc = flash[case_name(torch.bfloat16, False, WIDE_TIMED["d"])]
    for name, kind, line, count, library_ms in (
            ("flash_attention_fwd_wide_wgmma", "fwd", 88, "k1",
             wc["library"]["sdpa_fwd_ms"]),
            ("flash_attention_bwd_dq_wide_wgmma", "dq", 322, "k2a", None),
            ("flash_attention_bwd_dkv_wide_wgmma", "dkv", 367, "k2b",
             wc["library"]["sdpa_bwd_ms"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"dalle_pytorch_tpu/ops/flash_attention.py:{line}",
            "launches": wide_train["launches"][count],
            "max_abs_err": wc["max_abs_err"][kind],
            "ms": wc[kind]["ms"], "plain_ms": wc[kind]["plain_ms"],
            "bound_ms": wc[kind]["bound_ms"],
            "bound_by": wc[kind]["bound_by"], "library_ms": library_ms})
    # fused K2b's tensor-core bodies at the fused_train path's cases
    # (bfloat16, all-True mask; the north width and WIDE_TIMED), beside
    # SDPA's backward alone, which computes the same dq, dk and dv
    for name, fc_, width in (
            ("flash_attention_bwd_fused_wgmma", fc, "north"),
            ("flash_attention_bwd_fused_wide_wgmma", wc, "wide")):
        rows.append({
            "name": name, "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
            "replaces": "dalle_pytorch_tpu/ops/flash_attention.py:367",
            "launches": fused_train[width]["launches"]["k2b"],
            "max_abs_err": fc_["max_abs_err"]["fused"],
            "ms": fc_["fused"]["ms"], "plain_ms": fc_["fused"]["plain_ms"],
            "bound_ms": fc_["fused"]["bound_ms"],
            "bound_by": fc_["fused"]["bound_by"],
            "library_ms": fc_["library"]["sdpa_bwd_ms"]})
    # K3 at the sparse training path's case (bfloat16, all-True mask), and
    # K4's visible walk at the serving case (bfloat16 pages)
    k3 = sparse["k3"]["bfloat16/all_true"]
    vis = sparse["k4_visible"]["bfloat16"]
    rows += [{
        "name": "block_sparse_attention_fwd", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": sparse_train["launches"]["k3"],
        "max_abs_err": max(k3["max_abs_err"].values()),
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["sdpa_masked_ms"]}, {
        "name": "paged_decode_attention_visible", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": sparse_engine["k4_launches"]["visible"],
        "max_abs_err": vis["max_abs_err"], "ms": vis["ms"],
        "plain_ms": vis["plain_ms"], "bound_ms": vis["bound_ms"],
        "bound_by": vis["bound_by"], "library_ms": None}]
    # K3's wide tensor-core body at the wide_sparse_train path's case
    # (bfloat16, all-True mask, b 8, h 2, n 1280, d 256), beside SDPA with
    # the layout as a boolean mask
    k3w = sparse["k3"][case_name(torch.bfloat16, False, WIDE_TIMED["d"])]
    rows.append({
        "name": "block_sparse_attention_fwd_wide_wgmma", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": wide_sparse_train["launches"]["k3"],
        "max_abs_err": max(k3w["max_abs_err"].values()),
        "ms": k3w["ms"], "plain_ms": k3w["plain_ms"],
        "bound_ms": k3w["bound_ms"], "bound_by": k3w["bound_by"],
        "library_ms": k3w["sdpa_masked_ms"]})
    # K3 without the causal constraint, as the CLIP rerank of the
    # generate path runs it: the text encoder's case (bfloat16, n 256,
    # caption padding)
    k3c = sparse["k3"]["bfloat16/pad/noncausal/n256"]
    rows.append({
        "name": "block_sparse_attention_fwd_noncausal", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": generate["k3_launches"],
        "max_abs_err": max(k3c["max_abs_err"].values()),
        "ms": k3c["ms"], "plain_ms": k3c["plain_ms"],
        "bound_ms": k3c["bound_ms"], "bound_by": k3c["bound_by"],
        "library_ms": k3c["sdpa_masked_ms"]})
    # K4's wide split body at the wide serving shape (bfloat16 pages, 8
    # slots, heads=2, dim_head=256), both walks, launched by wide_engine
    for name, rec, walk, engine in (
            ("paged_decode_attention_wide", kernel["bfloat16/dh256/h2"],
             "prefix", "dense"),
            ("paged_decode_attention_visible_wide",
             sparse["k4_visible"]["bfloat16/dh256/h2"], "visible",
             "sparse_reads")):
        rows.append({
            "name": name, "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
            "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
            "launches": wide_engine[engine]["k4_launches"][walk],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    # the training slice's paths: the flash kernels at the north training
    # case (the reversible step, its backward recomputing K1; the MoE
    # model; the four remat modes), K3 without the causal constraint at
    # the CLIP text encoder's case (CLIP training), K4 at the serving case
    # (the reversible model's engine run)
    for path, rec in (("rev_train", rev_train), ("moe_train", moe_train),
                      ("remat", remat), ("cli", cli)):
        for name, kind, line, count, library_ms in (
                ("flash_attention_fwd", "fwd", 88, "k1",
                 lib["sdpa_fwd_ms"]),
                ("flash_attention_bwd_dq", "dq", 322, "k2a", None),
                ("flash_attention_bwd_dkv", "dkv", 367, "k2b",
                 lib["sdpa_bwd_ms"])):
            rows.append({
                "name": f"{name}@{path}", "route": "cuda",
                "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
                "replaces":
                    f"dalle_pytorch_tpu/ops/flash_attention.py:{line}",
                "launches": rec["launches"][count],
                "max_abs_err": fc["max_abs_err"][kind],
                "ms": fc[kind]["ms"], "plain_ms": fc[kind]["plain_ms"],
                "bound_ms": fc[kind]["bound_ms"],
                "bound_by": fc[kind]["bound_by"],
                "library_ms": library_ms})
    # training across ranks: each rank's launches in its 2 steps, summed
    # over the ranks and the runs at all 8 heads (dp, pp, fsdp, ep; none
    # under sp, as in JAX), then over the tp runs, whose ranks run 4 heads
    # each: those rows carry the kernels' numbers at that shape
    tpk = parallel["tp_kernels"]
    for name, kind, line, count, library_ms in (
            ("flash_attention_fwd", "fwd", 88, "k1", lib["sdpa_fwd_ms"]),
            ("flash_attention_bwd_dq", "dq", 322, "k2a", None),
            ("flash_attention_bwd_dkv", "dkv", 367, "k2b",
             lib["sdpa_bwd_ms"])):
        rows.append({
            "name": f"{name}@parallel", "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"dalle_pytorch_tpu/ops/flash_attention.py:{line}",
            "launches": sum(c[count] for run, runs in
                            parallel["launches"].items()
                            if not run.startswith("tp") for c in runs),
            "max_abs_err": fc["max_abs_err"][kind],
            "ms": fc[kind]["ms"], "plain_ms": fc[kind]["plain_ms"],
            "bound_ms": fc[kind]["bound_ms"],
            "bound_by": fc[kind]["bound_by"], "library_ms": library_ms})
        tf = tpk["flash"]
        rows.append({
            "name": f"{name}@parallel_tp", "route": "cuda",
            "source": "dalle_pytorch_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"dalle_pytorch_tpu/ops/flash_attention.py:{line}",
            "launches": sum(c[count] for run, runs in
                            parallel["launches"].items()
                            if run.startswith("tp") for c in runs),
            "max_abs_err": tf["max_abs_err"][kind],
            "ms": tf[kind]["ms"], "plain_ms": tf[kind]["plain_ms"],
            "bound_ms": tf[kind]["bound_ms"],
            "bound_by": tf[kind]["bound_by"],
            "library_ms": tf["library"]["sdpa_fwd_ms" if kind == "fwd"
                                        else "sdpa_bwd_ms"]
            if library_ms is not None else None})
    tk3 = tpk["k3"]
    # generate_dp's row: float32, a rank's rerank rows, the text encoder's
    # shape
    rk3 = tpk["k3_rerank"]
    rows.append({
        "name": "block_sparse_attention_fwd@parallel_tp", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": sum(c["k3"] for c in parallel["launches"]["tp_sparse"]),
        "max_abs_err": max(tk3["max_abs_err"].values()),
        "ms": tk3["ms"], "plain_ms": tk3["plain_ms"],
        "bound_ms": tk3["bound_ms"], "bound_by": tk3["bound_by"],
        "library_ms": tk3["sdpa_masked_ms"]})
    rows.append({
        "name": "block_sparse_attention_fwd_noncausal@generate_dp",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": sum(g["k3_launches"] for g in parallel["generate_dp"]),
        "max_abs_err": max(rk3["max_abs_err"].values()),
        "ms": rk3["ms"], "plain_ms": rk3["plain_ms"],
        "bound_ms": rk3["bound_ms"], "bound_by": rk3["bound_by"],
        "library_ms": rk3["sdpa_masked_ms"]})
    rows.append({
        "name": "block_sparse_attention_fwd@parallel", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": sum(c["k3"] for c in parallel["launches"]["pp_sparse"]),
        "max_abs_err": max(k3["max_abs_err"].values()),
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": k3["sdpa_masked_ms"]})
    rows.append({
        "name": "block_sparse_attention_fwd_noncausal@clip_train",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": clip_train["launches"]["k3"],
        "max_abs_err": max(k3c["max_abs_err"].values()),
        "ms": k3c["ms"], "plain_ms": k3c["plain_ms"],
        "bound_ms": k3c["bound_ms"], "bound_by": k3c["bound_by"],
        "library_ms": k3c["sdpa_masked_ms"]})
    rows.append({
        "name": "paged_decode_attention@rev_decode", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": rev_decode["k4_launches"],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None})
    # the single engine's features: K4 once per draft and verify offset
    # (run B, at one verify offset's row mask on the run's state), and K3
    # without the causal constraint in the postprocess worker's CLIP
    spec = features["B"]["k4_at_verify_offset"]
    rows += [{
        "name": "paged_decode_attention@serve_spec", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": features["B"]["k4_launches"],
        "max_abs_err": spec["max_abs_err"], "ms": spec["ms"],
        "plain_ms": spec["plain_ms"], "bound_ms": spec["bound_ms"],
        "bound_by": spec["bound_by"], "library_ms": None}, {
        "name": "block_sparse_attention_fwd_noncausal@postprocess",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": features["A"]["k3_launches"],
        "max_abs_err": max(k3c["max_abs_err"].values()),
        "ms": k3c["ms"], "plain_ms": k3c["plain_ms"],
        "bound_ms": k3c["bound_ms"], "bound_by": k3c["bound_by"],
        "library_ms": k3c["sdpa_masked_ms"]}]
    # the HTTP server: K4 in every decode step of the wave, K3 in the
    # postprocess worker's CLIP scores
    rows += [{
        "name": "paged_decode_attention@http", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": served["k4_launches"],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None}, {
        "name": "block_sparse_attention_fwd_noncausal@http",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": served["k3_launches"],
        "max_abs_err": max(k3c["max_abs_err"].values()),
        "ms": k3c["ms"], "plain_ms": k3c["plain_ms"],
        "bound_ms": k3c["bound_ms"], "bound_by": k3c["bound_by"],
        "library_ms": k3c["sdpa_masked_ms"]}]
    # the serving mesh's server: K3 in its postprocess worker's CLIP
    # scores (its decode reads through the gather: K4 is refused there)
    rows.append({
        "name": "block_sparse_attention_fwd_noncausal@mesh",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": mesh["k3_launches"],
        "max_abs_err": max(k3c["max_abs_err"].values()),
        "ms": k3c["ms"], "plain_ms": k3c["plain_ms"],
        "bound_ms": k3c["bound_ms"], "bound_by": k3c["bound_by"],
        "library_ms": k3c["sdpa_masked_ms"]})
    # the replica set behind the HTTP server: K4 in every replica's steps
    rows.append({
        "name": "paged_decode_attention@replicas", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": fleet["k4_launches"],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None})
    # process replicas behind the HTTP server: K4 in every child's steps
    # (the children's own counts, through their frames), K3 in the
    # parent's postprocess worker's CLIP scores
    rows += [{
        "name": "paged_decode_attention@process_replicas", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": procs["k4_launches"],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None}, {
        "name": "block_sparse_attention_fwd_noncausal@process_replicas",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": procs["k3_launches"],
        "max_abs_err": max(k3c["max_abs_err"].values()),
        "ms": k3c["ms"], "plain_ms": k3c["plain_ms"],
        "bound_ms": k3c["bound_ms"], "bound_by": k3c["bound_by"],
        "library_ms": k3c["sdpa_masked_ms"]}]
    # the gateway over cells: K4 in every cell's steps (A's thread cells
    # by the module count, B's children by their frames), K3 in B's
    # parents' CLIP scores
    rows += [{
        "name": "paged_decode_attention@gateway", "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/paged_attention.cu",
        "replaces": "dalle_pytorch_tpu/ops/paged_attention.py:88",
        "launches": gateway["k4_launches"],
        "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None}, {
        "name": "block_sparse_attention_fwd_noncausal@gateway",
        "route": "cuda",
        "source": "dalle_pytorch_tpu_torch/csrc/block_sparse.cu",
        "replaces": "dalle_pytorch_tpu/ops/block_sparse.py:80",
        "launches": gateway["k3_launches"],
        "max_abs_err": max(k3c["max_abs_err"].values()),
        "ms": k3c["ms"], "plain_ms": k3c["plain_ms"],
        "bound_ms": k3c["bound_ms"], "bound_by": k3c["bound_by"],
        "library_ms": k3c["sdpa_masked_ms"]}]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
