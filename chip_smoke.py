"""Chip smoke test of the PyTorch/CUDA port (attention_models_torch).

    python3 chip_smoke.py [--out results.json]

Needs one Hopper card. Phases, one line each (any failure raises):
  1. device   the card's name, nvidia-smi's name and power limit
  2. build    nvcc of attention_models_torch/csrc/*.cu (one process a file);
              ptxas's line for the flash forward (flash_fwd_bf16_kernel,
              the wgmma/TMA kernel of kernels 1, 9 and 16, and
              flash_fwd_f32_kernel, their fp32 register tiles) at d 64 and
              32, and for the backward's dkv and dq kernels (bf16 wgmma/TMA
              and fp32 register tiles, kernels 5, 10, 17 and 18) at d 64
              and 32, and for every instantiation of csrc/gemm_sm90.cuh's tile
              product (gemm_kernel): the GELU-MLP forwards' (csrc/mlp.cu,
              kernels 7 and 2: BN 128 and 256, GELU and residual
              epilogues), kernel 6's dual product and fp32 products
              (csrc/ln_mlp_bwd.cu), kernel 8's dual product, bf16 dx and
              fp32 products (csrc/mlp_bwd.cu), kernel 11's paired-column GEGLU product
              (BN 256) and y W2^T (BN 128 and 256; csrc/ffn.cu), kernel
              12's four (csrc/ffn_bwd.cu), kernel 13's and kernel 14's
              three (csrc/xent.cu), kernel 20's paired GEGLU product and
              int8 form, kernel 19's paired int8 product and kernel 21's
              int8 up-projection (csrc/quant.cu)
              and the five operand forms
              (csrc/tile_product.cu), and of the fp32 FMA kernels
              (csrc/gemm.cuh's gemm_f32_kernel in each source that
              instantiates it, csrc/ffn.cu's geglu_f32_kernel, csrc/xent.cu's
              xent_stats_f32_kernel and xent_grad_f32_kernel) and the GEGLU
              FFN's row passes (ffn_ln_rows_kernel,
              ffn_bwd_rows_kernel), kernel 20's fp32 up-projection on the
              fp64 tensor cores (geglu_f64_kernel), the W8A8 row passes
              (row_quant_kernel, row_codes_kernel, ln_codes_kernel),
              every LayerNorm
              instantiation
              (layernorm_kernel, layernorm_rows_kernel), the sampling
              epilogue's sixteen (sample_epilogue_kernel) and kernel 4's
              (codes_prep_kernel, nearest_codes_wgmma_kernel,
              nearest_codes_tiles_kernel, nearest_codes_any_kernel): registers, static
              shared memory, spill bytes (a spill fails)
  3. kernels  first the tile product's four operand forms (A and B each
              K-major or MN-major, K whole and split) and the fp32 FMA
              product's four layouts (A and B each kK or kR, tile width 128
              and 64) against torch.matmul of the same views (TF32 off),
              and the int8 form against torch._int_mm, bit for bit (ragged
              M, K 8704, K past its last box); then each kernel at the
              main path's
              shapes against its plain version on the card, in each dtype it takes, with kernel,
              plain and library (one PyTorch call; for a backward kernel
              its forward + backward) times and the bound; the repaired
              widths too (ln_mlp forward and backward at d 768 and 1024,
              nearest codes at widths 8 and 64, LayerNorm at d 8192);
              kernel 4 (bf16 on wgmma, fp32 on register tiles) bit-equal
              on a repeat call and in turns against the faster of cdist +
              argmin and addmm + argmin at (8192, 32) x 8192, and at bf16
              widths 8, 16 and 64 and width 20 (the first design, both
              dtypes) under the codebook index criterion, and at ragged
              shapes in both dtypes (the overfit's 32 x 64 codes at width
              8, (100, 77) at 8, 64 and 20, (520, 1000) at 16, 32 and 20,
              (8192, 8256) at 32); the
              fused GELU MLP (kernels 7 and 8) at ViT's shape (kernel 8
              also bit-equal on a repeat call and against its library
              chain, forward + backward, in turns); kernels 7
              and 2 at ragged rows (n 520: kernel 7 at ViT's widths, kernel
              2 at d 128, 256 and 384, hidden 1368) and both against their
              library chains in turns (kernel, library, library, kernel) at
              ViT's and the main path's shapes, beside the mma.sync kernels'
              times they replace; the
              separate-k/v flash pair (kernels 9 and 10) at the recon shape
              and at h 12, the per-head flash kernels (16, 17 and 18) at
              b 1, h 8, t 4096: bf16 and fp32, causal and not, tq != tk
              once, head width 64 and 32; and bit for bit, kernel 9 on the
              views kv[:, :, 0], kv[:, :, 1] against kernel 1 on the packed
              kv, kernel 10 against kernel 5, kernel 16 on the (b, h, t, d)
              transposes against kernel 9, kernels 17 + 18 against 10;
              the bf16 forward at a ragged length (b 2, h 8, t 1096, d 64,
              causal and not) through kernels 16 and 1 and at d 32 on the
              recon shape through kernel 1, against the plain versions; the
              bf16 forward against SDPA in turns (kernel, SDPA, SDPA,
              kernel) at the seven shapes of PERF.md's table, beside the
              ratio of the mma.sync kernel it replaced; the host cost of
              one forward call at Muse's shape; the bf16 backward at the
              ragged length through kernels 17 + 18 and 5 and at d 32
              through kernel 5, against the plain versions; the backward
              (delta, dkv, dq) against SDPA's forward + backward in turns at
              the ten shapes of PERF.md's backward rows (kernels 5, 10 and
              17 + 18, bf16 and fp32), beside the ratios of the kernels it
              replaced, 17 and 18 also alone; the LN-MLP backward (kernel
              6) at the main path's shape, at ragged rows (n 520) and at
              d 768 and 1024, and the head cross-entropy backward (kernel
              14) in bf16 with and without the bias, each with a bit-equal
              repeat call and against its library chain in turns beside
              the time it replaces; the GEGLU FFN forward and backward
              (kernels 11 and 12) in bf16 and fp32 at MaskGIT's shape, at
              ragged rows (n 520), at d 1024 and at inner 8704 (a row the
              row passes walk in chunks), each with a bit-equal
              repeat call, and in turns (both dtypes; kernel 11 also at
              Muse's shape) beside the times they replace; kernels 13 and
              14 in bf16 and fp32, with and without the bias, each with a
              bit-equal repeat call and in turns; the fp32 flash forward
              (kernels 1, 9 and 16) also at tq < tk and at t 1096, bit-equal
              on a repeat call, and against SDPA in turns at the recon shape
              (h 8 and 12) and at t 4096 (causal and not); the LayerNorm
              (kernel 3) at each of its shapes bit-equal on a repeat call
              and against F.layer_norm in turns; the W8A8 wide FFN (kernel
              20) at Muse's shape in both dtypes, bit-equal on a repeat
              call, 0 int8 codes differing from plain in fp32, and in turns;
              the W8A8 GEGLU FFN (kernel 19) at Muse's shape in both dtypes,
              0 int8 codes differing from plain, bit-equal on a repeat call;
              the W8A8 pre-LN MLP (kernel 21) at the int8 tokenizer's shape
              in both dtypes, 0 int8 codes differing from plain, bit-equal
              on a repeat call, and in turns; kernels 19-21 at rows past
              4096 (inner / hid 8704; kernel 20 in both dtypes) with their
              differing codes counted (kernel 21: none, and a bit-equal
              repeat call); the
              sampling epilogue at the six decode cases and at C 16384
              (rows wider than a block holds in registers); then this
              slice's shapes: kernel 4 at z (2048, 256) x 1024 codes (the
              first design) in both dtypes, bit-equal on a repeat call and
              in turns against addmm + argmin; kernel 3 at the
              Transformer's rows (1280 and 1344) at d 512 and 1365, both
              dtypes, bit-equal and in turns against F.layer_norm; kernels
              1 (b 16) and 5 (b 8) at t 256, h 16, both dtypes, bit-equal;
              kernels 13 and 14 at V 1024 (2048 rows, d 1024), both
              dtypes, bit-equal; kernel 15 at C 1024 (2048 CFG rows)
  4. block    one full-width ViTVQGANBlock (b 8, t 1024, d 512, bf16
              compute over fp32 parameters), forward + backward with the
              kernels against the same block on the plain versions: dx and
              every parameter gradient (the gate on the autograd wiring);
              then one full-width MaskGIT EncoderLayer + final_norm + head
              loss (b 8, t 1024, d 768, dropout 0.1 from one generator seed
              on both paths), the same gate
  5. main     the serving path: entry() (ViTVQGAN 256 px, bf16, batch 8,
              seeded weights), 3 requests through vq_recon_service and 1
              through vq_encode_service; every kernel's launch count must
              rise by its per-forward count; the same weights through the
              plain path on the card; recon imgs/s; recon imgs/s with the
              wrappers' direct no-grad launch against their autograd
              Functions (10 alternating pairs); device time by kernel
              over 3 traced recon requests (torch.profiler), and the
              ln_mlp products' (gemm_kernel) device time a request
  6. golden   fp32 encode_imgs, kernels against plain, TF32 off
  7. train    the training path: VQGANTrainer.train() on cfg/vitvqgan.yaml
              (restated in Python, TRAIN_OVERRIDES: synthetic data, 16
              examples, 2 epochs = 4 micro-steps, 2 optimizer steps);
              exact launch deltas per micro-step, finite losses, G and D
              parameters changing at the optimizer steps only, micro-step
              time, imgs/s, peak memory; device time by kernel over 2
              traced micro-steps
  8. maskgit  MaskGIT iterative decode: build_model on cfg/maskgit.yaml
              (restated in Python as MASKGIT_YAML, seeded weights) with
              training.mixed_precision=bf16, through maskgit_service:
              unconditional (batch 8, 18 steps, num_masked 1024, approx
              top-k), inpainting (batch 8, num_masked 200, approx) and
              exact mode once; exact launch deltas per call (MASKGIT_STEP per
              step, VQ_DECODE / VQ_ENCODE for the tokenizer); the first
              decode step's logits and picks, kernels against plain, in bf16
              and in fp32 (the shipped mixed_precision "no"), and the
              bf16 logits of both paths against the fp32 ones; layer 0's
              update in bf16, kernels and plain against fp32; whole-generate
              id agreement (reported); ms/step, images/s, peak memory; device
              time by kernel over one generate
  9. maskgit_train  MaskGIT training: build_model + build_trainer on
              cfg/maskgit.yaml with training.mixed_precision=bf16 and
              MASKGIT_TRAIN_OVERRIDES (cuts of scale only: synthetic data,
              32 examples = 4 micro-steps of batch 8, accumulation 2 = 2
              optimizer steps); exact launch deltas per micro-step
              (MASKGIT_TRAIN_STEP), finite losses, the vq tokenizer
              bit-equal throughout and without optimizer state, the
              schedule (constant_with_warmup: the first optimizer step runs
              at lr 0, so it moves the Adam moments and no parameter; the
              second moves them); micro-step time, images/s, peak memory;
              device time by kernel over 2 traced micro-steps
 10. fp32     one micro-step's loss and trainable gradients of the whole
              model in fp32 (TF32 off), kernels against plain, on the same
              weights, token grid, mask draws and dropout seed; the bf16
              model's loss and global gradient on the same inputs, each
              path against the fp32 plain one; then one micro-step of the
              shipped fp32 trainer (cfg/maskgit.yaml, mixed_precision no,
              TF32 off): ms of two micro-steps after a warm-up, 16 launches
              of kernel 5 in each, device time by kernel
 11. muse     Muse CFG decode: build_model on cfg/muse.yaml (restated in
              Python as MUSE_YAML, seeded weights) with
              training.mixed_precision=bf16 and model.quant none, int8_wide
              and int8, through muse_service (8 hash-tokenized prompts, 18
              steps, approx top-k; quant none in exact mode once); exact
              launch deltas per call (muse_step per step, the CLIP tower's
              LayerNorms and VQ_DECODE per generate); per mode the first
              decode step's logits and picks, kernels against plain, in bf16
              and in fp32 (the shipped mixed_precision "no"), the bf16 logits
              of both paths against the fp32 ones, layer 0's update in bf16;
              ms/step, images/s, peak memory; device time by kernel over one
              int8_wide generate
 12. recon_int8  the tokenizer built with quant int8 (vitvqgan_base, bf16,
              batch 8, 256 px): 3 requests through vq_recon_service with
              exact launch deltas (ln_mlp_q8 in place of ln_mlp), imgs/s, and
              index agreement with the unquantized model (reported)
 13. vit      one bf16 micro-step of cfg_exp/vitvqgan_overfit.yaml (the
              repaired widths on a training path: dim 64, code width 8,
              exact launches); then ViT: build_model + build_trainer on
              cfg/vit.yaml (restated in Python as VIT_YAML; VIT_OVERRIDES:
              synthetic labelled images, batch 64, 256 px): the eval
              forward's exact launch deltas (VIT_FORWARD: 14 LayerNorms, 6
              x kernel 7, no flash at 65 tokens), bf16 logits kernels vs
              plain and against the fp32 plain logits, eval imgs/s; 4
              training micro-steps at the shipped dropout 0.1 (no kernel
              7/8) and 4 at dropout 0 (6 x kernel 7 and 6 x kernel 8 each):
              exact launches, ms, imgs/s, peak memory; device time by kernel
              over 2 eval forwards and 2 training micro-steps; evaluate() on
              the ragged validation batch; one fp32 step (TF32 off), kernels
              vs plain
 14. longcontext  attention_models_torch.longcontext.longcontext(): causal
              flash attention, b 1, h 8, d 64, bf16, at t 4096, 8192 and
              16384, forward and forward + backward of out.float().sum()
              (kernel 16, then 17 and 18): exact launch deltas, ms per
              call beside SDPA's and the bound, peak memory above the
              inputs (< 1 GiB at t 16384: O(t), no (t, t) matrix); at
              t 16384 the output and gradients against the plain version
              taken 1024 query rows at a time
 15. ring     ring_flash_attention over 4 virtual shards, b 1, h 8,
              t 16384 (4096 a shard), d 64, bf16, non-causal and causal,
              forward and backward: exactly 16 launches of kernel 16 a
              forward and of kernels 17 and 18 a backward; output and
              gradients against the full-length kernels, every output
              finite, ms; then fp32 at t 4096 against the plain
              full-length attention
 16. flash_bthd  the separate-k/v API flash_attention_bthd at the recon
              shape, bf16: forward + backward through its autograd
              Function (one launch each of kernels 9 and 10) and one
              no-grad forward, against the fp32 plain attention
 17. vit_moe  ViT-MoE: build_model + build_trainer on cfg/vit_moe.yaml
              (restated in Python as VIT_MOE_YAML, cut in scale only by
              VIT_OVERRIDES as ViT is: synthetic labelled images, batch 64,
              256 px, bf16): the eval forward's exact launch deltas
              (VIT_MOE_FORWARD: 15 LayerNorms with beta, kernel 3; nothing
              else: no flash at 65 tokens, the MoE dispatch is PyTorch),
              bf16 logits kernels vs plain on the same routing and against
              the fp32 plain logits on its routing (every gate's logits
              pinned to the reference run's through forward hooks), the
              free-routing figures and the (token, head) routing decisions
              that differ reported; the pairs each layer's FFN MoE and
              output MoE drop at capacity factor 2.0, eval imgs/s and peak
              memory; 4 training micro-steps at the shipped dropout 0.1
              and 4 at dropout 0 (exact launches, ms, imgs/s, peak
              memory); device time by kernel over 2 eval forwards and 2
              training micro-steps; one fp32 step (TF32 off), kernels vs
              plain on the same routing (free routing reported)
 18. switchhead  one SwitchHeadAttention at a flash-sized length and
              ViT-MoE's width (b 8, t 1024, dim 1024, 16 x 64 heads, E 32,
              top-2, capacity factor 2.0, bf16): forward + backward through
              kernels 9 and 10 (one launch each, from the module) against
              the module on the plain attention; forward ms both ways
 19. agent    AgentAttention (no kernel: a path check), dim 1024, 49
              agents (7 heads of 64), t 1025, batch 8, bf16 against the
              same module in fp32 (TF32 off)
 20. parti    Parti serving: build_model on cfg/parti.yaml (restated in
              Python as PARTI_YAML; dim 1024, depth 12, 16 x 64 heads, the
              CLIP-L tower, vitvqgan_base; seeded weights, bf16): the
              first 16 cached decode steps' logits, fed a fixed grid,
              against the teacher-forced causal forward (kernel 1 causal)
              and kernels against plain, in bf16 and in fp32 (TF32 off);
              kernel 3's launches in one decode step by shape ((8, 1,
              1024) and (8, 1, 2730), 50 in all); greedy generates at
              guidance scale 0 and 3 (finite (8, 3, 256, 256) images,
              exact launches); the whole greedy generate's id agreement,
              kernels vs plain (reported); two parti_service generates
              of 8 hash-tokenized prompts (1024 tokens, approx top-k,
              temperature 1), the first with exact launch deltas: ms a
              token, images/s and peak memory; device time by kernel over
              16 decode steps
 21. parti_train  Parti training: one full-width causal DecoderLayer
              (context width 768) + final_norm + the biased head loss,
              kernels vs plain (bf16, every gradient); build_model +
              build_trainer on cfg/parti.yaml with GEN_TRAIN_OVERRIDES
              (synthetic captioned images, 32 examples = 4 micro-steps of
              batch 8, accumulation 4 = one optimizer step): exact launches
              a micro-step (kernels 1 causal, 5, 13 and 14 among them), ms,
              images/s, peak memory, device time by kernel over one
              micro-step; one fp32 micro-step of the whole model (TF32
              off), kernels vs plain
 22. muse_train  Muse training, the same on cfg/muse.yaml's widths (dim
              1024, depth 22, 16 x 64 heads, mult 6: kernels 11 and 12 at
              d 1024 / inner 4096, 1, 5, 13 and 14), GEN_TRAIN_OVERRIDES
              (batch 8, accumulation 4, bf16: the shipped config has batch
              1, accumulation 16, fp32); its layer gate is bidirectional
              with the unbiased head over targets 36 % ignored
 23. vqgan    the CNN tokenizer: build_model on cfg/vitvqgan.yaml with
              VQGAN_OVERRIDES (code width 256, 1024 codes; bf16 over fp32
              weights), seeded, batch 8, 256 px: 3 recon + 1 encode
              requests, kernel 4 once each (width 256: the first design;
              nothing else is a kernel); kernels vs plain (index criterion,
              recon rel L2 2e-2); recon and encode imgs/s over 10 requests;
              device time by kernel over 3 of each; the fp32 golden encode
              (TF32 off)
 24. vqgan_train  VQGANTrainer.train() on that config with TRAIN_OVERRIDES
              (4 micro-steps, 2 optimizer steps): exact launches, finite
              losses, ms, imgs/s, peak memory, device time by kernel over 2
              micro-steps
 25. muse_vqgan  Muse over the CNN tokenizer: build_model on
              cfg_exp/muse_vqgan.yaml (MUSE_VQGAN_YAML; dim 1024, 22 layers
              of 16 x 64, mult 6, CLIP-L; 256 tokens, 1024 classes), bf16,
              muse_service on the 8 prompts (18 steps, guidance 3, approx
              top-k) with exact launches; the first step's logits (bf16
              within FLOOR_RATIO x the plain path's nudged drift, which
              reads 2.1e-2 on this seeded model), layer 0's update and the
              fp32 logits and picks (the shipped "no", TF32 off) under
              phase 11's gates; ms/step, images/s, peak, device time by
              kernel
 26. muse_vqgan_train  the layer gate at t 256 and vocab 1024; 4
              micro-steps of MuseTrainer on MUSE_VQGAN_YAML with
              GEN_TRAIN_OVERRIDES (batch 8, accumulation 4, bf16: the
              shipped config has accumulation 16, fp32) and exact launches;
              an fp32 whole-model step, kernels vs plain
 27. transformer  the seq2seq Transformer: build_model + build_trainer on
              cfg/transformer.yaml (TRANSFORMER_YAML; dim 512, 16 x 64, 6 +
              6 layers, vocab 1000, batch 64, 20 tokens, bf16) with
              TRANSFORMER_OVERRIDES (4 micro-steps): 46 launches of kernel 3
              a micro-step and nothing else (flash gate and GEGLU gate fail,
              as in JAX), ms, target tokens/s, peak; on_sample's generate
              at max_len 21 (exact launches, ms, kernels vs plain id
              agreement reported); an fp32 step (TF32 off), kernels vs
              plain: loss 1e-5, every gradient 1e-4
 28. kernels  the closing map
The last two lines are the per-kernel JSON and {"ok": true, "device": ...}.
Each kernel's "launches" there is the sum of its counts over the twenty
driven paths (serving, training, maskgit, maskgit_train, muse, recon_int8,
vit, longcontext, ring, flash_bthd, vit_moe, switchhead, parti,
parti_train, muse_train, vqgan, vqgan_train, muse_vqgan, muse_vqgan_train,
transformer, each counted from 0), listed one by one beside it.

Tolerances (kernel against plain on the card):
  - bf16: relative L2 error |a - b| / |b| <= 1e-2 (bf16 rounds at ~4e-3);
  - fp32: relative L2 error <= 1e-5 (summation order only);
  - codebook indices: equal wherever the plain best/second-best distance gap
    exceeds 1e-5, and the chosen code's distance within 1e-5 of the minimum
    everywhere (fp32 sums in another order move distances by ~1 ulp);
  - whole model, bf16: the encoder output z and the decoder on identical
    indices within relative L2 2e-2 (1e-2 per op, compounded over 6 blocks);
    whole-model indices are reported, not gated: near-ties flip codes at bf16
    resolution;
  - whole model, fp32 indices: agree on >= 99.9 % of tokens, and every
    disagreement lies at a plain top-2 distance gap <= 1e-4;
  - backward kernels: relative L2 <= 2e-2 in bf16 (P and dS, G and dH are
    rounded to bf16 before the products that take them, as in the TPU
    kernels) and <= 1e-5 in fp32 (summation order only), on every output;
  - the full-width block: dx and every parameter gradient within relative
    L2 2e-2 of the plain path. No whole-model gradient is gated: codebook
    near-ties flip indices between the two paths;
  - the GEGLU FFN: relative L2 1e-2 in bf16, 1e-5 in fp32 (TF32 off);
  - the sampling epilogue, against its plain version on the same bits
    (given, or Philox computed by both): picks equal wherever the plain
    noised top-2 gap exceeds 1e-5 * |top|, every pick in the kept set, the
    score within relative 1e-5 where the picks agree; Philox in the kernel:
    temperature 0 is the argmax, a row's picks do not depend on the batch,
    8192 picks on constant logits cover >= 60 % of the classes (uniform
    sampling covers 63.2 %), another step gives other picks;
  - flash in bf16 is also held, at 1e-2, against the plain version without
    the kernels' rounding points (fp32 q and P throughout);
  - MaskGIT's first decode step: logits within relative L2 2e-2 in bf16
    (beside it the plain path's own drift when 1 % of the embedding rows
    move by about one bf16 ulp is reported: the seeded 16-layer model
    carries any bf16-level difference to about that size, so this gate
    sits on the model's floor); in fp32 (TF32 off) within 1e-4, and the
    picks equal wherever the plain noised top-2 gap exceeds 1e-4; the bf16
    logits' error against the fp32 plain logits, kernels at most
    FLOOR_RATIO (1.25) times the plain path's (two right bf16 paths read a
    ratio near 1, whatever the model's floor);
  - MaskGIT's layer 0 on the first step's hidden state, bf16, its update
    (out - h): kernels within relative L2 1e-2 of plain, and the kernels'
    error against the same layer in fp32 at most FLOOR_RATIO times the
    plain path's;
  - whole-generate ids are reported, not gated: one flipped near-tie
    changes every later step;
  - the GEGLU FFN's backward and the head cross-entropy's backward:
    relative L2 <= 2e-2 in bf16 (y, da, dgate and dl are rounded to bf16
    before the products that take them, as in the TPU kernels), <= 1e-5 in
    fp32, on every output; the head cross-entropy's forward: nll and lse
    within relative L2 1e-2 in bf16 (the logits are rounded to bf16), 1e-5
    in fp32;
  - the full-width MaskGIT layer with its head loss: dx and every
    parameter gradient within relative L2 2e-2 of the plain path;
  - the whole MaskGIT model in fp32 (TF32 off): the loss within relative
    1e-5 and every trainable gradient within relative L2 1e-4 of the plain
    path (summation order only); in bf16 the loss's and the global
    gradient's errors against the fp32 plain path, kernels at most
    FLOOR_RATIO times the plain path's;
  - the tile product's forms against torch.matmul of the same bf16 views
    in fp32 (TF32 off): relative L2 1e-4 (sums of up to 8192 exact
    products in another order); kernels 6 and 14 bit-equal on a repeat
    call (every sum in one fixed order, no atomics);
  - the W8A8 blocks (kernels 19-21): relative L2 1e-2 in bf16 and 1e-4 in
    fp32 (TF32 off), the int8 activations that differ from the plain
    version's counted and printed (the kernels take every fp32 step in the
    plain version's order and round once where it does, so they differ
    only where a statistic summed in another order lands an activation on
    the other side of a rounding boundary);
  - Muse's first decode step, per quant mode, kernels against plain.
    int8 codes are a step function of their input: an ulp that the
    LayerNorm, flash or FFN kernels round otherwise moves codes of the
    quant_dot projections and the FFN, and those move the logits by more
    than bf16 rounding does. So: bf16 logits within relative L2 2e-2 under
    quant none and, under int8 and int8_wide, within FLOOR_RATIO times the
    drift of the plain path itself when the position rows of 1 % of the
    tokens move by about one bf16 ulp (the model's floor, reported beside
    it); layer 0's update in bf16 within 1e-2, with all kernels under quant
    none and with the FFN kernel alone under the quant modes; in fp32 (TF32
    off) the logits within 1e-4 and the picks equal wherever the plain
    noised top-2 gap exceeds 1e-4, with all kernels under quant none and
    with the W8A8 FFN kernels alone under the quant modes (they equal the
    plain version's there), the all-kernel figures reported; in every mode
    the bf16 logits and layer 0's update against the fp32 plain path,
    kernels at most FLOOR_RATIO times the plain path's;
  - the int8 tokenizer's indices against the unquantized model's are
    reported, not gated;
  - the fused GELU MLP: relative L2 1e-2 (kernel 7) and 2e-2 on dx and
    every weight and bias gradient (kernel 8: g and dh are rounded to bf16
    before the products that take them, as in the TPU kernels), bf16;
  - nearest codes at widths 8 and 64 (fp32, TF32 off): every index equal
    to the plain version's; bf16 at widths 8, 16 and 64 and width 20 in
    both dtypes: the codebook index criterion; the ragged shapes: fp32 at
    widths 8-64 every index equal, else the index criterion;
  - the flash kernels 9, 10 and 16-18 against their plain versions: forward
    bf16 1e-2, backward bf16 2e-2, fp32 1e-5 (the plain versions round
    where the kernels do); the layout gates exactly (one template, the same
    arithmetic in the same order); long context at t 16384, against the
    chunked plain version, output 1e-2 and gradients 2e-2; the ring against
    the full-length kernels, output 1e-2 and gradients 2e-2 in bf16 (its
    merge of four chunks in fp32 is the only difference), against the plain
    full-length attention 1e-5 in fp32; flash_attention_bthd through
    autograd against the fp32 plain attention, 1e-2 and 2e-2;
  - ViT and ViT-MoE (bf16, batch 64): the logits within relative L2 2e-2
    of the plain path, and against the fp32 plain logits kernels at most
    FLOOR_RATIO times the plain path's; one fp32 step (TF32 off): the loss
    within relative 1e-5 and every gradient within relative L2 1e-4 of the
    plain path (summation order only; ViT-MoE's W_d.0 gates get no
    gradient on either path). ViT-MoE's comparisons run on one routing:
    the compared path's gate logits are pinned to the reference's. With
    free routing a one-ulp difference in a LayerNorm output flips top-2
    decisions at near ties, and a flipped decision moves its token by
    O(1): the seeded model's free bf16 logits differ from the plain
    path's by 3.4e-2 and the plain path's from fp32 by 4.3e-2 (reported,
    not gated);
  - SwitchHeadAttention at t 1024 (bf16): the output within relative L2
    1e-2 and dx and every parameter gradient within 2e-2 of the module on
    the plain attention (the attention is the only difference: both gates
    read the module's input);
  - AgentAttention: bf16 within relative L2 2e-2 of fp32 (two softmax
    stages rounded to bf16 and a bf16 convolution);
  - Parti's first 16 decode steps: the cached decode's logits within
    relative L2 2e-2 (bf16) and 1e-4 (fp32, TF32 off; fp32 at h 16 takes
    the plain attention on both paths) of the teacher-forced causal
    forward's, and kernels against plain within the same; the whole
    greedy generate's ids are reported, not gated: one flipped near-tie
    changes every later token;
  - Parti's and Muse's training: one full-width layer with its final norm
    and head loss, the loss and dx and every parameter gradient within
    relative L2 2e-2 of the plain path (bf16); the whole model in fp32
    (TF32 off), the loss within relative 1e-5 and every trainable
    gradient within relative L2 1e-4 of the plain path;
  - the CNN tokenizer: kernel 4 is its only kernel, so bf16 indices
    kernels vs plain under the codebook index criterion and the whole
    recon within relative L2 2e-2; the fp32 golden encode as phase 6's;
  - Muse over it: the bf16 first-step logits within FLOOR_RATIO x the
    plain path's drift under the one-ulp nudge (the seeded model's floor
    reads 2.1e-2, above quant none's fixed 2e-2), every other gate as
    quant none's in phase 11; its training as Muse's (the layer gate at
    t 256, V 1024);
  - the seq2seq Transformer in fp32 (TF32 off): the loss within relative
    1e-5 and every gradient within relative L2 1e-4 of the plain path
    (the same dropout draws); whole-generate ids reported, not gated.

Every profile (torch.profiler over traced calls) prints the device time
by kernel and the card's busy share, then a host line: the own CPU time
of the recorded ops, the kernel launches and their calls' time, the
optimizer's step and the backward (CPU time with children of the
autograd engine's outermost nodes); phase 27 lists its 15 largest host
ops.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12,    # fp32 outside the tensor cores
              "int8": 1979e12}     # dense tensor-core int8
BF16_TOL, F32_TOL, MODEL_BF16_TOL = 1e-2, 1e-5, 2e-2
FLOOR_RATIO = 1.25
BWD_BF16_TOL = 2e-2

# cfg/vitvqgan.yaml as PyYAML reads it (the card's machine promises no
# PyYAML); tests/test_torch_training.py holds the two equal
VITVQGAN_YAML = {
    "experiment": {
        "project_name": "vitvqgan", "exp_name": "run1",
        "max_train_examples": 1000000, "save_every": 500, "eval_every": 500,
        "sample_every": 500, "log_every": 100, "log_level": "info",
        "resume_path_from_checkpoint": None, "wandb": False},
    "codebook": {"codebook_dim": 32, "beta": 0.25, "codebook_size": 8192},
    "model": {"name": "vitvqgan", "transformer": {
        "dim": 512, "patch_size": 8, "n_heads": 8, "d_head": 64, "depth": 6,
        "dropout": 0.0, "mlp_dim": 2048}},
    "dataset": {
        "name": "coco",
        "params": {"train_path": "/datasets/coco2017", "val_path": None,
                   "num_workers": 4, "pin_memory": True, "batch_size": 8,
                   "persistent_workers": True, "shuffle": True,
                   "train_test_split": 0.9},
        "preprocessing": {"resolution": 256, "center_crop": False,
                          "random_flip": True, "random_crop": True,
                          "mean": None, "std": None, "scale": 0.66}},
    "optimizer": {"name": "adam", "params": {
        "learning_rate": 0.0001, "beta1": 0.9, "beta2": 0.999,
        "weight_decay": 0.0, "epsilon": "1e-8"}},
    "lr_scheduler": {"name": "timm_cosine", "params": {
        "learning_rate": "${optimizer.params.learning_rate}",
        "warmup_steps": 50000, "decay_steps": 100000}},
    "losses": {"per_loss_weight": 1, "adv_loss_weight": 0.1,
               "logit_laplace_weight": 1},
    "training": {"gradient_accumulation_steps": 2, "mixed_precision": "bf16",
                 "seed": 42, "num_epochs": 200, "max_grad_norm": 1.0,
                 "tensor_parallel": 1},
}
TRAIN_OVERRIDES = {"dataset.name": "synthetic",
                   "experiment.max_train_examples": 16,
                   "training.num_epochs": 2}
# kernel launches per training micro-step: 6 + 6 blocks, 16 LayerNorms
# (patch norm1 + norm2, two pre_norms, 12 norm1s), one codebook lookup;
# each block's attention and ln_mlp backward once
PER_MICRO_STEP = {"flash_attention_bthd_kv": 12, "ln_mlp": 12,
                  "layernorm": 16, "nearest_codes": 1,
                  "flash_attention_bwd_kv": 12, "ln_mlp_bwd": 12,
                  "ffn": 0, "sample_epilogue": 0, "ffn_bwd": 0,
                  "head_xent": 0, "head_xent_bwd": 0, "ffn_q8": 0,
                  "ffn_q8wide": 0, "ln_mlp_q8": 0, "mlp": 0, "mlp_bwd": 0}

# cfg/maskgit.yaml as PyYAML reads it; tests/test_torch_port_rules.py holds
# the two equal
MASKGIT_YAML = {
    "experiment": {
        "project_name": "maskgit", "exp_name": "run1",
        "max_train_examples": 10000000, "save_every": 1000, "eval_every": 500,
        "sample_every": 10000000, "log_every": 500, "log_level": "info",
        "resume_path_from_checkpoint": None, "wandb": False},
    "codebook": {"codebook_dim": 32, "beta": 0.25, "codebook_size": 8192},
    "vitvqgan": {
        "checkpoint": "outputs/vitvqgan/checkpoints/VitVQGAN.pt",
        "transformer": {"dim": 512, "patch_size": 8, "n_heads": 8,
                        "d_head": 64, "depth": 6, "dropout": 0.0,
                        "mlp_dim": 2048}},
    "model": {"name": "maskgit", "dim": 768, "n_heads": 12, "d_head": 64,
              "depth": 16, "mult": 8, "dropout": 0.1},
    "dataset": {
        "name": "coco",
        "params": {"train_path": "/datasets/coco2017", "val_path": None,
                   "num_workers": 4, "pin_memory": True, "batch_size": 8,
                   "persistent_workers": True, "shuffle": True,
                   "train_test_split": 0.9},
        "preprocessing": {"resolution": 256, "center_crop": False,
                          "random_flip": False, "random_crop": True,
                          "mean": None, "std": None, "scale": 1.0}},
    "optimizer": {"name": "adamw", "params": {
        "learning_rate": "1e-4", "beta1": 0.9, "beta2": 0.999,
        "weight_decay": 0.01}},
    "lr_scheduler": {"name": "constant_with_warmup", "params": {
        "learning_rate": "${optimizer.params.learning_rate}",
        "warmup_steps": 1000, "decay_steps": None}},
    "training": {"gradient_accumulation_steps": 32, "mixed_precision": "no",
                 "seed": 42, "num_epochs": 200, "max_grad_norm": None,
                 "tensor_parallel": 1},
}
# kernel launches of the tokenizer under MaskGIT (bf16): decode_indices runs
# the decoder (pre_norm + 6 blocks of norm1, attention, fused LN + MLP);
# encode_imgs the encoder (patch norms, pre_norm, 6 blocks) and the codebook
VQ_DECODE = {"flash_attention_bthd_kv": 6, "ln_mlp": 6, "layernorm": 7}
VQ_ENCODE = {"flash_attention_bthd_kv": 6, "ln_mlp": 6, "layernorm": 9,
             "nearest_codes": 1}


# MaskGIT training on cfg/maskgit.yaml, cut in scale only: synthetic
# images, 32 examples = 4 micro-steps of batch 8 in one epoch, accumulation
# 2 = 2 optimizer steps (training.mixed_precision=bf16 is the timed path's
# dotted override, as in phase 8)
MASKGIT_TRAIN_OVERRIDES = {"dataset.name": "synthetic",
                           "experiment.max_train_examples": 32,
                           "training.num_epochs": 1,
                           "training.gradient_accumulation_steps": 2}
# kernel launches per MaskGIT training micro-step (cache_vq_tokens off,
# bf16): the frozen tokenizer's encode (VQ_ENCODE) and the transformer's
# forward (maskgit_step without the epilogue), the fused head loss, then the
# backward: each layer's FFN and attention once, the head once (the
# gamma-LayerNorms' backward is the plain vjp, as in JAX)
MASKGIT_TRAIN_STEP = {"flash_attention_bthd_kv": 16 + 6, "ln_mlp": 6,
                      "layernorm": 34 + 9, "nearest_codes": 1, "ffn": 16,
                      "ffn_bwd": 16, "flash_attention_bwd_kv": 16,
                      "head_xent": 1, "head_xent_bwd": 1, "ln_mlp_bwd": 0,
                      "sample_epilogue": 0}


# cfg/vit.yaml as PyYAML reads it; tests/test_torch_vit.py holds the two
# equal
VIT_YAML = {
    "experiment": {
        "project_name": "vit", "exp_name": "run1",
        "max_train_examples": 100000000, "save_every": 1000,
        "eval_every": 1000, "sample_every": 100000000, "log_every": 100,
        "log_level": "info", "resume_path_from_checkpoint": None,
        "wandb": False},
    "model": {"name": "vit", "transformer": {
        "dim": 1024, "patch_size": 32, "n_heads": 16, "d_head": 64,
        "depth": 6, "mlp_dim": 2048, "dropout": 0.1, "num_classes": 1000}},
    "dataset": {
        "name": "imagenet",
        "params": {"train_path": "/datasets/imagenet/train", "val_path": None,
                   "num_workers": 4, "pin_memory": True, "batch_size": 64,
                   "persistent_workers": True, "shuffle": True,
                   "train_test_split": 0.95},
        "preprocessing": {"resolution": 256, "center_crop": False,
                          "random_flip": True, "random_crop": True,
                          "mean": None, "std": None, "scale": 0.85}},
    "optimizer": {"name": "adamw", "params": {
        "learning_rate": "3e-4", "beta1": 0.9, "beta2": 0.999,
        "weight_decay": 0.05}},
    "lr_scheduler": {"name": "cosine_with_warmup", "params": {
        "learning_rate": "${optimizer.params.learning_rate}",
        "warmup_steps": 10000, "decay_steps": None}},
    "training": {"gradient_accumulation_steps": 1, "mixed_precision": "bf16",
                 "seed": 42, "num_epochs": 300, "max_grad_norm": 1.0,
                 "tensor_parallel": 1},
}
# ViT on cfg/vit.yaml, cut in scale only: synthetic labelled images (64 a
# set, so one batch of 64 an epoch; the 16 validation images are one ragged
# batch; labels of 10 of the 1000 classes, as the JAX loader gives them),
# 4 epochs = 4 micro-steps
VIT_OVERRIDES = {"dataset.name": "synthetic",
                 "dataset.params.with_captions": False,
                 "training.num_epochs": 4}
# kernel launches per ViT forward (bf16): the 2 patch-embed LayerNorms and 2
# gamma-LayerNorms a block; kernel 7 once a block under the JAX gate; the
# 65-token attention takes the plain attention (no flash). A training
# micro-step adds kernel 8 once a block when dropout is 0 (the LayerNorms'
# backward is the plain vjp, as in JAX)
VIT_FORWARD = {"layernorm": 2 + 2 * 6, "mlp": 6}
# cfg/vit_moe.yaml as PyYAML reads it (cfg/vit.yaml with its MoE keys);
# tests/test_torch_vit_moe.py holds the two equal. It runs with
# VIT_OVERRIDES, cut in scale as ViT is
VIT_MOE_YAML = json.loads(json.dumps(VIT_YAML))
VIT_MOE_YAML["experiment"]["project_name"] = "vit_moe"
VIT_MOE_YAML["model"] = {"name": "vit_moe", "transformer": {
    **VIT_YAML["model"]["transformer"], "n_experts": 32, "sel_experts": 2,
    "capacity_factor": 2.0}}
# kernel launches per ViT-MoE forward (bf16) and per training micro-step:
# the 2 patch-embed LayerNorms, norm1 and norm2 a block and the final norm
# (kernel 3 with beta); the 65-token attention takes the plain attention
# (no flash) and the MoE dispatch is PyTorch, so nothing else launches
VIT_MOE_FORWARD = {"layernorm": 2 + 2 * 6 + 1}

# cfg_exp/vitvqgan_overfit.yaml as PyYAML reads it; tests/test_torch_vit.py
# holds the two equal
VQGAN_OVERFIT_YAML = {
    "experiment": {
        "project_name": "vitvqgan_overfit", "exp_name": "test",
        "max_train_examples": 2, "save_every": 1000000, "eval_every": 4,
        "sample_every": 4, "log_every": 1, "log_level": "info",
        "resume_path_from_checkpoint": None, "wandb": False},
    "codebook": {"codebook_dim": 8, "beta": 0.25, "codebook_size": 64},
    "model": {"name": "vitvqgan", "transformer": {
        "dim": 64, "patch_size": 8, "n_heads": 2, "d_head": 32, "depth": 1,
        "dropout": 0.0, "mlp_dim": 128}},
    "dataset": {
        "name": "synthetic",
        "params": {"train_path": None, "val_path": None, "num_workers": 0,
                   "pin_memory": False, "batch_size": 2,
                   "persistent_workers": False, "shuffle": True,
                   "train_test_split": None},
        "preprocessing": {"resolution": 32, "center_crop": False,
                          "random_flip": False, "random_crop": False,
                          "mean": None, "std": None, "scale": 1.0}},
    "optimizer": {"name": "adam", "params": {
        "learning_rate": 0.001, "beta1": 0.9, "beta2": 0.999,
        "weight_decay": 0.0, "epsilon": "1e-8"}},
    "lr_scheduler": {"name": "timm_cosine", "params": {
        "learning_rate": "${optimizer.params.learning_rate}",
        "warmup_steps": 2, "decay_steps": 100}},
    "losses": {"per_loss_weight": 0.1, "adv_loss_weight": 0.1,
               "logit_laplace_weight": 1},
    "training": {"gradient_accumulation_steps": 1, "mixed_precision": "no",
                 "seed": 42, "num_epochs": 3, "max_grad_norm": 1.0,
                 "tensor_parallel": 1},
}


def vit_config(dropout: float | None, output_dir: str,
               mixed_precision: str = "bf16", yaml: dict = VIT_YAML):
    """cfg/vit.yaml (or ``yaml``) with VIT_OVERRIDES,
    ``model.transformer.dropout`` (None: the shipped 0.1) and
    ``training.mixed_precision``."""
    from attention_models_torch.utils.config import Config

    cfg = Config(json.loads(json.dumps(yaml)))
    for k, v in VIT_OVERRIDES.items():
        cfg.set_path(k, v)
    if dropout is not None:
        cfg.set_path("model.transformer.dropout", dropout)
    cfg.set_path("training.mixed_precision", mixed_precision)
    cfg.set_path("experiment.output_dir", output_dir)
    return cfg


def vit_moe_config(dropout: float | None, output_dir: str,
                   mixed_precision: str = "bf16"):
    """cfg/vit_moe.yaml with VIT_OVERRIDES, the dropout and the precision,
    as ``vit_config``."""
    return vit_config(dropout, output_dir, mixed_precision, VIT_MOE_YAML)


def maskgit_step(depth: int, approx: bool) -> dict:
    """Launches of one decode step: attention and the GEGLU FFN once a
    layer, the gamma LayerNorms init_norm + 2 a layer + final_norm, and the
    sampling epilogue once in approx mode."""
    return {"flash_attention_bthd_kv": depth, "ffn": depth,
            "layernorm": 2 * depth + 2, "sample_epilogue": int(approx)}


# cfg/muse.yaml as PyYAML reads it; tests/test_torch_port_rules.py holds
# the two equal
MUSE_YAML = {
    "experiment": {
        "project_name": "muse", "exp_name": "run1",
        "max_train_examples": 10000000000, "save_every": 1000,
        "eval_every": 50000000000000, "sample_every": 500, "log_every": 100,
        "log_level": "info", "resume_path_from_checkpoint": None,
        "wandb": False},
    "codebook": {"codebook_dim": 32, "beta": 0.25, "codebook_size": 8192},
    "vitvqgan": MASKGIT_YAML["vitvqgan"],
    "model": {"name": "muse", "dim": 1024,
              "encoder": {"type": "clip",
                          "name": "openai/clip-vit-large-patch14",
                          "max_length": 77},
              "decoder": {"n_heads": 16, "d_head": 64, "depth": 22,
                          "mult": 6, "embeds_drop_prob": 0.9,
                          "dropout": 0.0}},
    "dataset": {
        "name": "coco",
        "params": {"train_path": "/datasets/coco2017", "val_path": None,
                   "num_workers": 4, "pin_memory": True, "batch_size": 1,
                   "persistent_workers": True, "shuffle": True,
                   "train_test_split": 0.9},
        "preprocessing": {"resolution": 256, "center_crop": False,
                          "random_flip": False, "random_crop": True,
                          "mean": None, "std": None, "scale": 1.0}},
    "optimizer": {"name": "adamw", "params": {
        "learning_rate": "1e-4", "beta1": 0.9, "beta2": 0.999,
        "weight_decay": 0.01}},
    "lr_scheduler": {"name": "constant_with_warmup", "params": {
        "learning_rate": "${optimizer.params.learning_rate}",
        "warmup_steps": 1000, "decay_steps": None}},
    "training": {"gradient_accumulation_steps": 16, "mixed_precision": "no",
                 "seed": 42, "num_epochs": 200, "max_grad_norm": None,
                 "tensor_parallel": 1},
}
MUSE_PROMPTS = ["a stop sign", "two cats on a red sofa",
                "a bowl of ramen on a wooden table", "a lighthouse at dusk",
                "an astronaut riding a horse", "a watercolor of a fox",
                "a city street in the rain", "a plate of fresh fruit"]
# kernel launches per Muse generate besides its steps: the CLIP tower's
# LayerNorms (2 a layer + the final one) and the tokenizer's decode
CLIP_LAYERNORMS = 2 * 12 + 1
MUSE_FFN = {None: "ffn", "int8_wide": "ffn_q8wide", "int8": "ffn_q8"}


def muse_step(depth: int, quant: str | None, approx: bool) -> dict:
    """Launches of one Muse decode step (one 2b-row forward): the
    self-attention's flash and the FFN once a layer (the cross-attention
    over 77 text tokens is the plain attention, as JAX runs XLA there), the
    gamma LayerNorms norm1-3 a layer + final_norm, and the sampling
    epilogue once in approx mode."""
    return {"flash_attention_bthd_kv": depth, MUSE_FFN[quant]: depth,
            "layernorm": 3 * depth + 1, "sample_epilogue": int(approx)}


def muse_config(mixed_precision: str, quant: str | None):
    """cfg/muse.yaml with training.mixed_precision and model.quant set."""
    from attention_models_torch.utils.config import Config

    cfg = Config(json.loads(json.dumps(MUSE_YAML)))
    cfg.set_path("training.mixed_precision", mixed_precision)
    if quant is not None:
        cfg.set_path("model.quant", quant)
    return cfg


# cfg/parti.yaml as PyYAML reads it; tests/test_torch_generator_training.py
# holds the two equal
PARTI_YAML = {
    "experiment": {
        "project_name": "parti", "exp_name": "run1",
        "max_train_examples": 10000000000, "save_every": 1000,
        "eval_every": 50000000000, "sample_every": 1000, "log_every": 100,
        "log_level": "info", "resume_path_from_checkpoint": None,
        "wandb": False},
    "codebook": {"codebook_dim": 32, "beta": 0.25, "codebook_size": 8192},
    "vitvqgan": MASKGIT_YAML["vitvqgan"],
    "model": {"name": "parti", "dim": 1024, "n_heads": 16, "d_head": 64,
              "depth": 12,
              "encoder": {"type": "clip",
                          "name": "openai/clip-vit-large-patch14",
                          "max_length": 77}},
    "dataset": {
        "name": "coco",
        "params": {"train_path": "/datasets/coco2017", "val_path": None,
                   "num_workers": 4, "pin_memory": True, "batch_size": 8,
                   "persistent_workers": True, "shuffle": True,
                   "train_test_split": 0.9},
        "preprocessing": MUSE_YAML["dataset"]["preprocessing"]},
    "optimizer": MUSE_YAML["optimizer"],
    "lr_scheduler": {"name": "cosine_with_warmup", "params": {
        "learning_rate": "${optimizer.params.learning_rate}",
        "warmup_steps": 5000, "decay_steps": 500000}},
    "training": {"gradient_accumulation_steps": 4, "mixed_precision": "bf16",
                 "seed": 42, "num_epochs": 100, "max_grad_norm": 1.0,
                 "tensor_parallel": 1},
}
# Parti's and Muse's training, cut in scale only: synthetic captioned
# images, 32 examples = 4 micro-steps of batch 8 in one epoch, accumulation
# 4 = one optimizer step, bf16 (Muse ships batch 1, accumulation 16, fp32)
GEN_TRAIN_OVERRIDES = {"dataset.name": "synthetic",
                       "experiment.max_train_examples": 32,
                       "training.num_epochs": 1,
                       "dataset.params.batch_size": 8,
                       "training.gradient_accumulation_steps": 4,
                       "training.mixed_precision": "bf16"}


def parti_step(depth: int) -> dict:
    """Launches of one cached Parti decode step: kernel 3 for init_norm,
    norm1-3 and the FFN's gamma LayerNorm (2730 wide) a layer, and
    final_norm; nothing else (the attention over the cache and over the
    77 text tokens is plain, as JAX runs XLA there, and the FFN's inner
    2730 fails the GEGLU kernel's gate)."""
    return {"layernorm": 2 + 4 * depth}


def parti_train_step(depth: int) -> dict:
    """Launches of one Parti training micro-step: the frozen tokenizer's
    encode (VQ_ENCODE), the CLIP tower's LayerNorms and context_norm, then
    the causal decoder (kernel 1 a layer; init_norm, 4 LayerNorms a layer,
    final_norm) and the biased head loss (kernel 13), and the backward:
    kernel 5 a layer and kernel 14 once (the LayerNorms' backward is the
    plain vjp, as in JAX)."""
    want = dict(VQ_ENCODE)
    want["layernorm"] += CLIP_LAYERNORMS + 1 + 2 + 4 * depth
    want["flash_attention_bthd_kv"] += depth
    want.update(flash_attention_bwd_kv=depth, head_xent=1, head_xent_bwd=1)
    return want


def muse_train_step(depth: int, encode: dict = VQ_ENCODE) -> dict:
    """Launches of one Muse training micro-step: the tokenizer's encode
    (VQ_ENCODE; CNN_ENCODE over the CNN tokenizer), the CLIP tower's
    LayerNorms, the decoder (kernel 1, the GEGLU FFN (kernel 11) and 3
    gamma LayerNorms a layer, final_norm) and the head loss (kernel 13);
    the backward: kernels 5 and 12 a layer and kernel 14 once."""
    want = {"layernorm": 0, "flash_attention_bthd_kv": 0, **encode}
    want["layernorm"] += CLIP_LAYERNORMS + 3 * depth + 1
    want["flash_attention_bthd_kv"] += depth
    want.update(flash_attention_bwd_kv=depth, ffn=depth, ffn_bwd=depth,
                head_xent=1, head_xent_bwd=1)
    return want


# cfg_exp/muse_vqgan.yaml as PyYAML reads it; tests/test_torch_muse_vqgan.py
# holds the two equal
MUSE_VQGAN_YAML = {
    "experiment": {
        "project_name": "muse_vqgan", "exp_name": "run1",
        "max_train_examples": 10000000000, "save_every": 1000,
        "eval_every": 50000000000, "sample_every": 500, "log_every": 100,
        "log_level": "info", "resume_path_from_checkpoint": None,
        "wandb": False},
    "codebook": {"codebook_dim": 256, "beta": 0.25, "codebook_size": 1024},
    "model": {"name": "muse_vqgan", "dim": 1024,
              "encoder": MUSE_YAML["model"]["encoder"],
              "decoder": MUSE_YAML["model"]["decoder"]},
    "dataset": {
        "name": "coco",
        "params": {"train_path": "/datasets/coco2017", "val_path": None,
                   "num_workers": 4, "pin_memory": True, "batch_size": 8,
                   "persistent_workers": True, "shuffle": True,
                   "train_test_split": 0.9},
        "preprocessing": MUSE_YAML["dataset"]["preprocessing"]},
    "optimizer": MUSE_YAML["optimizer"],
    "lr_scheduler": MUSE_YAML["lr_scheduler"],
    "training": MUSE_YAML["training"],
}
# kernel launches of the CNN tokenizer (any dtype): encode_imgs and the
# training forward run kernel 4 once; the convolutions, GroupNorms and the
# NonLocal attention are PyTorch, so decode_indices launches nothing
CNN_ENCODE = {"nearest_codes": 1}
# the CNN tokenizer of inference/vqgan.py and muse_vqgan (code width 256,
# 1024 codes) under cfg/vitvqgan.yaml's training settings
VQGAN_OVERRIDES = {"model.name": "vqgan", "codebook.codebook_dim": 256,
                   "codebook.codebook_size": 1024}

# cfg/transformer.yaml as PyYAML reads it; tests/test_torch_transformer.py
# holds the two equal
TRANSFORMER_YAML = {
    "experiment": {
        "project_name": "transformer", "exp_name": "run1",
        "max_train_examples": 100000000, "save_every": 1000,
        "eval_every": 500, "sample_every": 1000, "log_every": 100,
        "log_level": "info", "resume_path_from_checkpoint": None,
        "wandb": False},
    "model": {"name": "transformer", "dim": 512, "vocab_size": 1000,
              "n_heads": 16, "d_head": 64, "enc_depth": 6, "dec_depth": 6,
              "n_classes": 1000},
    "dataset": {
        "name": "seq2seq",
        "params": {"num_examples": 100000, "seq_len": 20,
                   "vocab_size": "${model.vocab_size}", "num_workers": 0,
                   "batch_size": 64, "shuffle": True},
        "preprocessing": {"resolution": 0}},
    "optimizer": {"name": "adamw", "params": {
        "learning_rate": "3e-4", "beta1": 0.9, "beta2": 0.98,
        "weight_decay": 0.01}},
    "lr_scheduler": {"name": "cosine_with_warmup", "params": {
        "learning_rate": "${optimizer.params.learning_rate}",
        "warmup_steps": 4000, "decay_steps": None}},
    "training": {"gradient_accumulation_steps": 1, "mixed_precision": "bf16",
                 "seed": 42, "num_epochs": 20, "max_grad_norm": 1.0,
                 "tensor_parallel": 1},
}
# the Transformer's training, cut in scale only: 256 examples = 4
# micro-steps of batch 64 in one epoch
TRANSFORMER_OVERRIDES = {"experiment.max_train_examples": 256,
                         "training.num_epochs": 1}


def transformer_step(enc_depth: int, dec_depth: int) -> dict:
    """Launches of one Transformer training micro-step: kernel 3 for
    enc_init_norm, norm1, norm2 and the FFN's gamma LayerNorm (1365 wide) a
    layer and enc_final_norm, then dec_init_norm, norm1-3 and the FFN's a
    layer and dec_final_norm; nothing else (20 and 21 tokens fail the flash
    gate and inner 1365 the GEGLU kernel's, as in JAX; the LayerNorms'
    backward is the plain vjp)."""
    return {"layernorm": 2 + 3 * enc_depth + 2 + 4 * dec_depth}


def transformer_generate(enc_depth: int, dec_depth: int,
                         max_len: int) -> dict:
    """Launches of one generate: the encoder's (as in training), then
    norm1-3 and the FFN's LayerNorm a decoder layer a step (generate
    applies no init or final norm around the decoder)."""
    return {"layernorm": 2 + 3 * enc_depth + max_len * 4 * dec_depth}


def vqgan_config(mixed_precision: str, output_dir: str):
    """cfg/vitvqgan.yaml with VQGAN_OVERRIDES, TRAIN_OVERRIDES and
    training.mixed_precision, outputs under output_dir."""
    cfg = training_config(output_dir)
    for k, v in VQGAN_OVERRIDES.items():
        cfg.set_path(k, v)
    cfg.set_path("training.mixed_precision", mixed_precision)
    return cfg


def muse_vqgan_config(mixed_precision: str):
    """cfg_exp/muse_vqgan.yaml with training.mixed_precision set."""
    from attention_models_torch.utils.config import Config

    cfg = Config(json.loads(json.dumps(MUSE_VQGAN_YAML)))
    cfg.set_path("training.mixed_precision", mixed_precision)
    return cfg


def transformer_config(mixed_precision: str, output_dir: str):
    """cfg/transformer.yaml with TRANSFORMER_OVERRIDES and
    training.mixed_precision, outputs under output_dir."""
    from attention_models_torch.utils.config import Config

    cfg = Config(json.loads(json.dumps(TRANSFORMER_YAML)))
    for k, v in TRANSFORMER_OVERRIDES.items():
        cfg.set_path(k, v)
    cfg.set_path("training.mixed_precision", mixed_precision)
    cfg.set_path("experiment.output_dir", output_dir)
    return cfg


def parti_config(mixed_precision: str):
    """cfg/parti.yaml with training.mixed_precision set."""
    from attention_models_torch.utils.config import Config

    cfg = Config(json.loads(json.dumps(PARTI_YAML)))
    cfg.set_path("training.mixed_precision", mixed_precision)
    return cfg


def gen_train_config(yaml: dict, output_dir: str):
    """cfg/parti.yaml or cfg/muse.yaml (``yaml``) with GEN_TRAIN_OVERRIDES,
    outputs under output_dir."""
    from attention_models_torch.utils.config import Config

    cfg = Config(json.loads(json.dumps(yaml)))
    for k, v in GEN_TRAIN_OVERRIDES.items():
        cfg.set_path(k, v)
    cfg.set_path("experiment.output_dir", output_dir)
    return cfg


def maskgit_config(mixed_precision: str):
    """cfg/maskgit.yaml with training.mixed_precision overridden."""
    from attention_models_torch.utils.config import Config

    cfg = Config(json.loads(json.dumps(MASKGIT_YAML)))
    cfg.set_path("training.mixed_precision", mixed_precision)
    return cfg


def maskgit_train_config(output_dir: str):
    """cfg/maskgit.yaml, bf16, with MASKGIT_TRAIN_OVERRIDES."""
    cfg = maskgit_config("bf16")
    for k, v in MASKGIT_TRAIN_OVERRIDES.items():
        cfg.set_path(k, v)
    cfg.set_path("experiment.output_dir", output_dir)
    return cfg


def training_config(output_dir: str):
    """cfg/vitvqgan.yaml with TRAIN_OVERRIDES, outputs under output_dir."""
    from attention_models_torch.utils.config import Config

    cfg = Config(json.loads(json.dumps(VITVQGAN_YAML)))
    for k, v in TRAIN_OVERRIDES.items():
        cfg.set_path(k, v)
    cfg.set_path("experiment.output_dir", output_dir)
    return cfg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2

    import numpy as np

    import attention_models_torch as amt
    from attention_models_torch.entry import entry
    from attention_models_torch.models.vitvqgan import vitvqgan_base
    from attention_models_torch.ops import _build, dispatch
    from attention_models_torch.ops import ffn as ffn_mod
    from attention_models_torch.ops.gemm_sm90 import (
        tile_product, tile_product_s8)
    from attention_models_torch.ops import flash_attention as flash_mod
    from attention_models_torch.ops import layernorm as ln_mod
    from attention_models_torch.ops.codebook import (
        _nearest_codes_reference, l2_normalize, nearest_codes)
    from attention_models_torch.data.loaders import build_loader
    from attention_models_torch.models.factory import build_model
    from attention_models_torch.models.layers import (
        GammaLayerNorm, lecun_normal_)
    from attention_models_torch.models.transformer import EncoderLayer
    from attention_models_torch.models.vitvqgan import ViTVQGANBlock
    from attention_models_torch.ops.ffn import (
        _ffn_backward_reference, _ffn_reference, _fused_mlp_backward_reference,
        _fused_mlp_reference, _ln_mlp_backward_reference, _ln_mlp_reference,
        fused_ffn, fused_ffn_backward, fused_ln_mlp, fused_ln_mlp_backward,
        fused_mlp, fused_mlp_backward)
    from attention_models_torch.ops.xent import (
        _head_xent_backward_reference, _head_xent_fwd_kernel,
        _head_xent_loss_reference, _head_xent_reference, fused_head_xent,
        head_xent_backward)
    from attention_models_torch.ops.attention import make_causal_mask
    from attention_models_torch.ops.flash_attention import (
        _flash_backward_bthd_reference, _flash_backward_heads_reference,
        _flash_backward_reference, _flash_bthd_reference,
        _flash_bwd_dkv_reference, _flash_bwd_dq_reference,
        _flash_forward_reference, _flash_reference, flash_attention,
        flash_attention_bthd, flash_attention_bthd_kv,
        flash_attention_bwd_bthd, flash_attention_bwd_kv, flash_bwd_dkv,
        flash_bwd_dq, flash_delta, flash_forward)
    from attention_models_torch.ops.ring_attention import (
        ring_flash_attention)
    from attention_models_torch.longcontext import longcontext, make_inputs
    from attention_models_torch.training.build_trainer import build_trainer
    from attention_models_torch.ops.layernorm import _ln_reference, layernorm
    from attention_models_torch.ops.sampling import (
        _sample_epilogue_reference, gumbel_of_bits, kth_value_bisect,
        philox_bits, sample_epilogue_fused)
    from attention_models_torch.serving import (
        maskgit_service, muse_service, parti_service, vq_encode_service,
        vq_recon_service)
    from attention_models_torch.training.transformer_trainer import (
        ce_and_acc)
    from attention_models_torch.models.layers import FeedForward, LayerNorm
    from attention_models_torch.models.parti import parti_generate
    from attention_models_torch.models.text_encoder import tokenize
    from attention_models_torch.models.transformer import DecoderLayer
    from attention_models_torch.ops.quant import (
        _ffn_q8_reference, _ffn_q8wide_reference, _ln_mlp_q8_reference,
        fused_ffn_q8, fused_ffn_q8wide, fused_ln_mlp_q8, int_dot,
        quantize_rows, quantize_weight)

    F = torch.nn.functional
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 1 --
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name} | sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}"
          f" | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"nvidia-smi: {smi}", flush=True)

    # ---------------------------------------------------------------- 2 --
    def gate(ok, what):
        if not ok:
            raise AssertionError(what)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s -> {lib_path.name}",
          flush=True)
    # the flash forward (bf16 wgmma/TMA, fp32 register tiles) at both head
    # widths: registers, static shared memory and spills as ptxas reports
    # them; a spill fails
    ptxas = {}
    for kern in ("flash_fwd_bf16_kernel", "flash_fwd_f32_kernel"):
        for r in _build.ptxas_report("flash_attention", kern):
            d = 64 if "ILi64E" in r["name"] else 32
            ptxas[f"{kern}<{d}>"] = r
            print(f"[ptxas] {kern}<{d}>: {r['registers']} registers, "
                  f"{r['smem']} bytes smem, {r['spill_stores']} bytes spill "
                  f"stores, {r['spill_loads']} bytes spill loads", flush=True)
    gate(len(ptxas) == 4
         and all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                 for r in ptxas.values()),
         f"flash forward ptxas: {ptxas}")
    # the flash backward's dkv and dq kernels (bf16 wgmma/TMA and fp32
    # register tiles) at both head widths: registers, static shared memory
    # (the kernels take dynamic shared memory) and spills; a spill fails
    bwd_ptxas = {}
    for kern in ("flash_bwd_dkv_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                 "flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel"):
        for r in _build.ptxas_report("flash_attention_bwd", kern):
            d = 64 if "ILi64E" in r["name"] else 32
            bwd_ptxas[f"{kern}<{d}>"] = r
            print(f"[ptxas] {kern}<{d}>: {r['registers']} registers, "
                  f"{r['smem']} bytes smem, {r['spill_stores']} bytes spill "
                  f"stores, {r['spill_loads']} bytes spill loads", flush=True)
    gate(len(bwd_ptxas) == 8
         and all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                 for r in bwd_ptxas.values()),
         f"flash backward ptxas: {bwd_ptxas}")
    # every instantiation of csrc/gemm_sm90.cuh's tile product: the GELU-MLP
    # forwards' (kernels 7 and 2: BN 128, two blocks an SM, so at most 112
    # registers, and 256; GELU and residual epilogues), kernel 6's dual
    # product (one block an SM) and its fp32 products, kernel 11's
    # paired-column GEGLU product (BN 256) and y W2^T (BN 128 and 256: 128
    # only where d is 128), kernel 12's
    # four, kernel 13's statistics product, kernel 14's three, kernel 20's
    # paired GEGLU product (BN 256) and its int8 down-projection (the S8
    # form, DequantStore in bf16 and fp32 at BN 128 and 256), and the five
    # operand forms of the checks below (the int8 one at BN 128), kernel 8's
    # dual product, bf16 dx and fp32 weight gradients, kernel 21's int8
    # up-projection (DequantBiasGelu at BN 128; its down-projection is the
    # S8 DequantStore above); a spill fails
    epilogues = (("GegluDequant", "geglu dequant"),
                 ("DequantBiasGelu", "dequant bias gelu"),
                 ("DequantStoreIfE", "dequant f32"),
                 ("DequantStoreI13__nv_bfloat16E", "dequant bf16"),
                 ("BiasActILb1E", "gelu"), ("BiasActILb0E", "residual"),
                 ("StoreIfE", "f32"), ("StoreI13__nv_bfloat16E", "bf16"),
                 ("GeluBwd", "gelu backward"), ("XentDl", "dl"),
                 ("XentStats", "stats"), ("GegluF32", "geglu"))

    def gemm_label(mangled):
        bn = re.search(r"gemm_kernelILi(\d+)E", mangled).group(1)
        if "8PairedS8E" in mangled:
            form = "K, K paired int8"
        elif "6PairedE" in mangled:
            form = "K, K paired"
        elif "2S8E" in mangled:
            form = "K, K int8"
        else:
            form = ", ".join("K" if v == "0" else "MN" for v in re.search(
                r"FormILi(n?\d)ELi(n?\d)ELi(n?\d)ELi(n?\d)E",
                mangled).groups() if v != "n1")
        epi = next(e for key, e in epilogues if key in mangled)
        return f"gemm_kernel<{bn}, {form}, {epi}>"

    def ptxas_line(label, r):
        print(f"[ptxas] {label}: {r['registers']} registers, {r['smem']} "
              f"bytes smem, {r['spill_stores']} bytes spill stores, "
              f"{r['spill_loads']} bytes spill loads", flush=True)

    mlp_ptxas = {}
    for src, count in (("mlp", 4), ("ln_mlp_bwd", 3), ("mlp_bwd", 3),
                       ("xent", 4), ("tile_product", 5), ("ffn", 3),
                       ("ffn_bwd", 4), ("quant", 7)):
        rows = _build.ptxas_report(src, "gemm_kernel")
        for r in rows:
            label = f"{src}: {gemm_label(r['name'])}"
            mlp_ptxas[label] = r
            ptxas_line(label, r)
        gate(len(rows) == count, f"{src}: {len(rows)} gemm_kernel "
             f"instantiations, expected {count}")
    gate(len(mlp_ptxas) == 33
         and all(r["spill_stores"] == 0 and r["spill_loads"] == 0
                 for r in mlp_ptxas.values()),
         f"gemm_kernel ptxas: {mlp_ptxas}")
    # the fp32 FMA product (tile width 128 and 64, each kK / kR layout pair
    # a source uses), kernel 11's fp32 GEGLU product, kernel 13's fp32
    # statistics and kernel 14's fp32 dl pass (both on the FMA product) and
    # the GEGLU FFN's row passes (bf16 and fp32, 4 and 8 pieces a thread);
    # a spill fails
    fma_ptxas = {}
    for src, kern, count in (("ffn", "gemm_f32_kernel", 2),
                             ("ffn_bwd", "gemm_f32_kernel", 6),
                             ("xent", "gemm_f32_kernel", 4),
                             ("xent", "xent_stats_f32_kernel", 1),
                             ("xent", "xent_grad_f32_kernel", 1),
                             ("tile_product", "gemm_f32_kernel", 8),
                             ("ffn", "geglu_f32_kernel", 1),
                             ("ffn", "ffn_ln_rows_kernel", 4),
                             ("ffn_bwd", "ffn_bwd_rows_kernel", 4)):
        rows = _build.ptxas_report(src, kern)
        for r in rows:
            m = re.search(r"ILi(\d+)ELi(\d)ELi(\d)E", r["name"])
            tmpl = re.search(r"kernelI(f|13__nv_bfloat16)Li(\d)E", r["name"])
            if m:
                label = (f"{src}: {kern}<{m.group(1)}, "
                         f"{'kK' if m.group(2) == '0' else 'kR'}, "
                         f"{'kK' if m.group(3) == '0' else 'kR'}>")
            elif tmpl:
                dt = "float" if tmpl.group(1) == "f" else "bf16"
                label = f"{src}: {kern}<{dt}, {tmpl.group(2)}>"
            else:
                label = f"{src}: {kern}"
            fma_ptxas[label] = r
            ptxas_line(label, r)
        gate(len(rows) == count, f"{src}: {len(rows)} {kern} "
             f"instantiations, expected {count}")
    gate(all(r["spill_stores"] == 0 and r["spill_loads"] == 0
             for r in fma_ptxas.values()), f"fp32 FMA / row pass ptxas: "
         f"{fma_ptxas}")
    # kernel 20's fp32 up-projection on the fp64 tensor cores (256 threads,
    # one block an SM: up to 255 registers), the W8A8 row pass (LayerNorm
    # and codes, 4 or 1 columns a thread, rows walked in chunks past 4096)
    # in each instantiation and
    # every instantiation of the LayerNorm kernel (dtype, piece width,
    # pieces a lane; its row-loop kernel beside them), and kernel 4's (the
    # |e|^2 pass, the bf16 wgmma argmin: 288 threads, two blocks an SM, so
    # at most 112 registers, and the fp32 register tiles: two blocks an SM,
    # so at most 128, at widths 8, 16, 32 and 64; the any-width kernel); a
    # spill fails
    def tmpl_label(src, kern, mangled):
        seg = mangled.split(kern + "I", 1)[1]
        seg = seg[:seg.index("Ev")]
        args = [("bf16" if m.group(0).startswith("13") else "float"
                 if m.group(0) == "f" else m.group(1) or
                 ("true" if m.group(2) == "1" else "false"))
                for m in re.finditer(r"13__nv_bfloat16|Li(\d+)E|Lb(\d)E|f",
                                     seg)]
        return f"{src}: {kern}<{', '.join(args)}>"

    for src, kern, count in (("quant", "geglu_f64_kernel", 1),
                             ("quant", "row_quant_kernel", 8),
                             ("quant", "row_codes_kernel", 3),
                             ("quant", "ln_codes_kernel", 2),
                             ("sampling", "sample_epilogue_kernel", 16),
                             ("codebook", "codes_prep_kernel", 8),
                             ("codebook", "nearest_codes_wgmma_kernel", 4),
                             ("codebook", "nearest_codes_tiles_kernel", 4),
                             ("codebook", "nearest_codes_any_kernel", 2),
                             ("layernorm", "layernorm_kernel", 23),
                             ("layernorm", "layernorm_rows_kernel", 2)):
        rows = _build.ptxas_report(src, kern)
        for r in rows:
            label = (tmpl_label(src, kern, r["name"]) if kern + "I" in r["name"]
                     else f"{src}: {kern}")
            fma_ptxas[label] = r
            ptxas_line(label, r)
        gate(len(rows) == count and len({tmpl_label(src, kern, r["name"])
                                         if kern + "I" in r["name"] else ""
                                         for r in rows}) == count,
             f"{src}: {len(rows)} {kern} instantiations, expected {count}")
    gate(all(r["spill_stores"] == 0 and r["spill_loads"] == 0
             for r in fma_ptxas.values()), f"fp32 DMMA / row pass / "
         f"LayerNorm ptxas: {fma_ptxas}")

    # ---------------------------------------------------------------- 3 --
    def time_ms(fn, iters=20):
        for _ in range(3):
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

    def device_ms(fn, iters=20):
        """time_ms with the launches queued behind a sleep on the card, so
        the events bracket device time only: no gap where the card waits
        for the host to enqueue the next call"""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # cycles (about 1.2 ms an iteration at 1.75 GHz): longer than the
        # host takes to enqueue an iteration, autograd's included
        torch.cuda._sleep(int(2e6 + 2e6 * iters))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def rel_l2(a, b):
        a, b = a.double(), b.double()
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    def max_abs(a, b):
        return float((a.float() - b.float()).abs().max())

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def bound(bytes_moved, ops):
        """ops: [(count, peak type)], each at its type's peak"""
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = sum(n / PEAK_FLOPS[k] for n, k in ops) * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                     "operations")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    variants = []

    def record(kernel, label, dtype, tol, err, abs_err, ms, plain_ms,
               lib_ms, bytes_moved, flops, metric="rel_l2", main=False):
        """``main``: the variant at the main path's dtype and shape that the
        kernels line reports (default: the kernel's first bf16 variant).
        ``flops``: a count at the dtype's peak, or [(count, peak type)]."""
        b_ms, b_by = bound(bytes_moved, flops if isinstance(flops, list)
                           else [(flops, str(dtype).split(".")[-1])])
        v = dict(kernel=kernel, variant=label, dtype=str(dtype).split(".")[-1],
                 metric=metric, err=err, tol=tol, max_abs_err=abs_err, ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, main=main)
        variants.append(v)
        print(f"[kernel] {kernel} {label}: {metric} {err:.3e} (tol {tol:g}) "
              f"max_abs {abs_err:.3e} | kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library "
              f"{'-' if lib_ms is None else format(lib_ms, '.4f')} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        gate(err <= tol, f"{kernel} {label}: {metric} {err} > {tol}")
        return v

    # csrc/gemm_sm90.cuh's tile product in each operand form alone
    # (csrc/tile_product.cu: A and B each K-major or MN-major, fp32 out, K
    # whole or split into ordered partials) against torch.matmul of the same
    # views, before the kernels built on the forms (6 and 14) are checked:
    # relative L2 <= 1e-4 (fp32 sums of up to 8192 exact bf16 products in
    # another order)
    form_errs = {}
    for fm, fn_, fk in ((520, 384, 1000), (4096, 1024, 8192)):
        fa = randn(fm, fk, dtype=torch.bfloat16)
        fb = randn(fn_, fk, dtype=torch.bfloat16)
        fwant = fa.float() @ fb.float().T
        for am, bm, split in itertools.product((0, 1), (0, 1), (False, True)):
            fgot = tile_product(fa if am == 0 else fa.T.contiguous(), am,
                                fb if bm == 0 else fb.T.contiguous(), bm,
                                split=split)
            label = (f"({fm},{fn_},{fk}) A {'K' if am == 0 else 'MN'}-major "
                     f"B {'K' if bm == 0 else 'MN'}-major split={split}")
            form_errs[label] = rel_l2(fgot, fwant)
            print(f"[form] {label}: rel_l2 {form_errs[label]:.3e} (tol 1e-4)",
                  flush=True)
    gate(all(e <= 1e-4 for e in form_errs.values()),
         f"tile product forms: {form_errs}")
    # csrc/gemm.cuh's register-tiled fp32 FMA product (gemm_f32, kernels 11,
    # 12 and 14 in fp32) in each layout (A and B each kK, stored (rows, K),
    # or kR, stored (K, rows)) at both tile widths against torch.matmul with
    # TF32 off: relative L2 <= 1e-5 (exact fp32 sums of up to 8192 terms in
    # another order)
    f32_form_errs = {}
    for fm, fn_, fk in ((520, 384, 1000), (4096, 1024, 8192)):
        fa, fb = randn(fm, fk), randn(fn_, fk)
        fwant = fa @ fb.T
        for am, bm, tw in itertools.product((0, 1), (0, 1), (128, 64)):
            fgot = tile_product(fa if am == 0 else fa.T.contiguous(), am,
                                fb if bm == 0 else fb.T.contiguous(), bm,
                                tile_width=tw)
            label = (f"({fm},{fn_},{fk}) A {'kK' if am == 0 else 'kR'} "
                     f"B {'kK' if bm == 0 else 'kR'} width {tw}")
            f32_form_errs[label] = rel_l2(fgot, fwant)
            print(f"[form] fp32 {label}: rel_l2 {f32_form_errs[label]:.3e} "
                  f"(tol 1e-5)", flush=True)
    gate(all(e <= 1e-5 for e in f32_form_errs.values()),
         f"fp32 FMA product layouts: {f32_form_errs}")
    del fa, fb, fwant, fgot
    # the tile product's int8 form (kernel 20's down-projection: TMA boxes
    # of 128 int8 of K, wgmma .s32.s8.s8) against torch._int_mm on the same
    # codes, bit for bit: unit scales give float(acc) itself, row and column
    # scales (float(acc) * s_row) * s_col; at ragged M (520 rows), at K
    # 8704 and past K's last box (TMA's zero fill must add nothing)
    s8_equal = {}
    for fm, fn_, fk in ((520, 768, 8704), (16384, 1024, 4096),
                        (520, 384, 1040)):
        fa = torch.randint(-127, 128, (fm, fk), generator=gen, device=dev,
                           dtype=torch.int8)
        fb = torch.randint(-127, 128, (fn_, fk), generator=gen, device=dev,
                           dtype=torch.int8)
        acc = int_dot(fa, fb)
        sr, sc = randn(fm, scale=1e-3).abs(), randn(fn_, scale=1e-3).abs()
        label = f"({fm},{fn_},{fk})"
        s8_equal[label] = (torch.equal(tile_product_s8(fa, fb), acc)
                           and torch.equal(tile_product_s8(fa, fb, sr, sc),
                                           (acc * sr[:, None]) * sc))
        print(f"[form] int8 {label}: bit-equal to torch._int_mm "
              f"{s8_equal[label]}", flush=True)
    gate(all(s8_equal.values()), f"int8 tile product: {s8_equal}")
    del fa, fb, acc

    def in_turns(row, shape, run, lib, before, flops, peak="bfloat16",
                 bytes_moved=0):
        """Device time of ``run`` against its library chain in turns
        (kernel, library, library, kernel; launches queued behind a sleep),
        then back to back, beside the time it replaces (PERF.md's table,
        same card type); the bound: ``flops`` (a count, or [(count, peak
        type)]) at their types' rates, or ``bytes_moved`` at the memory
        rate, whichever is longer."""
        k1, l1, l2, k2 = (device_ms(run), device_ms(lib), device_ms(lib),
                          device_ms(run))
        bk1, bl1, bl2, bk2 = (time_ms(run), time_ms(lib), time_ms(lib),
                              time_ms(run))
        b_ms = bound(bytes_moved, flops if isinstance(flops, list)
                     else [(flops, peak)])[0]
        r = dict(row=row, shape=shape, dtype=peak, kernel_ms=(k1 + k2) / 2,
                 library_ms=(l1 + l2) / 2, ratio=(k1 + k2) / (l1 + l2),
                 back_to_back_kernel_ms=(bk1 + bk2) / 2,
                 back_to_back_library_ms=(bl1 + bl2) / 2,
                 back_to_back_ratio=(bk1 + bk2) / (bl1 + bl2),
                 before_ms=before, bound_ms=b_ms)
        print(f"[turns] kernel {row} {shape} {peak}: device kernel {k1:.4f} / "
              f"{k2:.4f} ms, library {l1:.4f} / {l2:.4f} ms, kernel/library "
              f"{r['ratio']:.3f}; back to back {bk1:.4f} / {bk2:.4f} against "
              f"{bl1:.4f} / {bl2:.4f}, {r['back_to_back_ratio']:.3f} (before "
              f"{before} ms back to back); bound {b_ms:.4f} ms "
              f"({100 * b_ms / r['kernel_ms']:.1f} % of it)", flush=True)
        return r

    def repeat_equal(name, fn, first):
        """Two calls on the same inputs give the same bits."""
        again = fn()
        gate(all(a is None and b is None or torch.equal(a, b)
                 for a, b in zip(first, again)),
             f"{name}: a repeat call gave other bits")
        print(f"[kernel] {name}: a repeat call is bit-equal", flush=True)

    bwd_turns = []

    n_tok, dim, patch_feat, hid = 8 * 1024, 512, 192, 1368

    mg_dim, mg_inner, mg_heads = 768, 4096, 12  # cfg/maskgit.yaml's widths

    # LayerNorm: the model-width rows (bf16 in the bf16 model, fp32 in the
    # fp32 one), the patch-embed rows (fp32 images from the services),
    # MaskGIT's gamma-only rows (no beta), Muse's (16 x 1024 rows at d
    # 1024, no beta) and its CLIP tower's (8 x 77 rows at d 768, beta); each
    # bit-equal on a repeat call and read against F.layer_norm in turns
    # beside the time it replaces (PERF.md's table, back to back; the
    # kernel's device time inside kernel 2 at (8192, 512) was 11.74 us)
    ln_before = {(n_tok, dim, torch.bfloat16): 0.0198,
                 (n_tok, dim, torch.float32): 0.0180,
                 (n_tok, patch_feat, torch.float32): 0.0259,
                 (n_tok, mg_dim, torch.bfloat16): 0.0242,
                 (n_tok, mg_dim, torch.float32): 0.0234,
                 (16 * 1024, 1024, torch.bfloat16): 0.0307,
                 (8 * 77, 768, torch.bfloat16): 0.0279}
    ln_turns = []
    for rows, d, dtype, beta in ((n_tok, dim, torch.bfloat16, True),
                                 (n_tok, dim, torch.float32, True),
                                 (n_tok, patch_feat, torch.float32, True),
                                 (n_tok, patch_feat, torch.bfloat16, True),
                                 (n_tok, mg_dim, torch.bfloat16, False),
                                 (n_tok, mg_dim, torch.float32, False),
                                 (16 * 1024, 1024, torch.bfloat16, False),
                                 (8 * 77, 768, torch.bfloat16, True)):
        x = randn(rows, d, dtype=dtype, scale=2.0, shift=0.5)
        g = randn(d, scale=0.1, shift=1.0)
        b = randn(d, scale=0.1) if beta else None
        got, want = layernorm(x, g, b), _ln_reference(x, g, b, 1e-5)
        gl, bl = g.to(dtype), b.to(dtype) if beta else None
        ln_label = f"({rows},{d})" + ("" if beta else " no beta")
        record("layernorm", ln_label,
               dtype, BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
               rel_l2(got, want), max_abs(got, want),
               time_ms(lambda: layernorm(x, g, b)),
               time_ms(lambda: _ln_reference(x, g, b, 1e-5)),
               time_ms(lambda: F.layer_norm(x, (d,), gl, bl)),
               nbytes(x, x, g, *([b] if beta else [])), 8 * x.numel())
        repeat_equal(f"layernorm {ln_label} {str(dtype)[6:]}",
                     lambda: (layernorm(x, g, b),), (got,))
        ln_turns.append(in_turns(
            3, ln_label, lambda: layernorm(x, g, b),
            lambda: F.layer_norm(x, (d,), gl, bl),
            ln_before.get((rows, d, dtype)), 8 * x.numel(),
            str(dtype).split(".")[-1],
            bytes_moved=nbytes(x, x, g, *([b] if beta else []))))

    # fused LN + MLP, bf16 only (the fp32 model runs LN kernel + matmuls)
    x = randn(n_tok, dim, dtype=torch.bfloat16)
    lng, lnb = randn(dim, scale=0.1, shift=1.0), randn(dim, scale=0.1)
    w1 = randn(hid, dim, dtype=torch.bfloat16, scale=dim ** -0.5)
    b1 = randn(hid, dtype=torch.bfloat16, scale=0.1)
    w2 = randn(dim, hid, dtype=torch.bfloat16, scale=hid ** -0.5)
    b2 = randn(dim, dtype=torch.bfloat16, scale=0.1)
    mlp_args = (x, lng, lnb, w1, b1, w2, b2)
    got, want = fused_ln_mlp(*mlp_args), _ln_mlp_reference(*mlp_args, 1e-5)
    # the MLP part alone, out - x: a tighter look than the residual sum
    # (2e-2: out is rounded to bf16 at |x|'s scale before x is taken off)
    mlp_err = rel_l2(got.float() - x.float(), want.float() - x.float())
    print(f"[kernel] ln_mlp MLP part (out - x): rel_l2 {mlp_err:.3e} "
          f"(tol 2e-2)", flush=True)
    if not mlp_err <= 2e-2:
        raise AssertionError(f"ln_mlp MLP part: rel_l2 {mlp_err}")
    lng_b, lnb_b = lng.to(torch.bfloat16), lnb.to(torch.bfloat16)

    def ln_mlp_library():
        h = F.linear(F.layer_norm(x, (dim,), lng_b, lnb_b), w1, b1)
        return x + F.linear(F.gelu(h), w2, b2)

    record("ln_mlp", f"({n_tok},{dim}) hid {hid}", torch.bfloat16, BF16_TOL,
           rel_l2(got, want), max_abs(got, want),
           time_ms(lambda: fused_ln_mlp(*mlp_args)),
           time_ms(lambda: _ln_mlp_reference(*mlp_args, 1e-5)),
           time_ms(ln_mlp_library),
           nbytes(x, x, lng, lnb, w1, b1, w2, b2), 4 * n_tok * dim * hid)

    # flash attention on packed kv, both dtypes, plus causal at tq = tk;
    # ViTVQGAN's 8 heads, MaskGIT's 12 and Muse's 16 (its 16-row CFG batch;
    # in fp32 the JAX gate sends h 16 to the plain attention)
    b_, t_, h_, d_ = 8, 1024, 8, 64
    for bb, hh, dtype, causal in ((b_, h_, torch.bfloat16, False),
                                  (b_, h_, torch.float32, False),
                                  (b_, h_, torch.bfloat16, True),
                                  (b_, h_, torch.float32, True),
                                  (b_, mg_heads, torch.bfloat16, False),
                                  (b_, mg_heads, torch.float32, False),
                                  (16, 16, torch.bfloat16, False)):
        q = randn(bb, t_, hh, d_, dtype=dtype)
        kv = randn(bb, t_, 2, hh, d_, dtype=dtype)
        out, lse = flash_attention_bthd_kv(q, kv, causal=causal)
        out_p, lse_p = _flash_reference(q, kv, d_ ** -0.5, causal)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        lse_err = rel_l2(lse, lse_p)
        if not lse_err <= tol:
            raise AssertionError(f"flash lse rel_l2 {lse_err} > {tol}")
        # bf16: also against the plain version without the kernels' rounding
        # points (fp32 q and P throughout), gated alike
        unrounded = ""
        if dtype == torch.bfloat16:
            out_u = _flash_reference(q.float(), kv.float(), d_ ** -0.5,
                                     causal)[0].to(dtype)
            u_err = rel_l2(out, out_u)
            if not u_err <= tol:
                raise AssertionError(f"flash against the unrounded plain "
                                     f"version: rel_l2 {u_err} > {tol}")
            unrounded = f", unrounded plain rel_l2 {u_err:.3e}"
        qs = q.transpose(1, 2).contiguous()
        ks = kv[:, :, 0].transpose(1, 2).contiguous()
        vs = kv[:, :, 1].transpose(1, 2).contiguous()
        pairs = t_ * (t_ + 1) // 2 if causal else t_ * t_
        record("flash_attention_bthd_kv",
               f"b{bb} t{t_} h{hh} d{d_} causal={causal} (lse rel_l2 "
               f"{lse_err:.2e}{unrounded})", dtype, tol,
               rel_l2(out, out_p), max_abs(out, out_p),
               time_ms(lambda: flash_attention_bthd_kv(q, kv, causal=causal)),
               time_ms(lambda: _flash_reference(q, kv, d_ ** -0.5, causal)),
               time_ms(lambda: F.scaled_dot_product_attention(
                   qs, ks, vs, is_causal=causal)),
               nbytes(q, kv, out, lse), 4 * bb * hh * d_ * pairs)

    def plain_distances(z, codes):
        zf, cf = z.float(), codes.float()
        return torch.sum(cf * cf, dim=-1)[None, :] - 2.0 * (zf @ cf.T)

    def index_report(idx, idx_p, dist):
        top2 = dist.topk(2, dim=1, largest=False).values
        gap = top2[:, 1] - top2[:, 0]
        differ = idx.long() != idx_p.long()
        chosen = dist.gather(1, idx.long()[:, None])[:, 0]
        return (float((~differ).float().mean()),
                float(gap[differ].max()) if bool(differ.any()) else 0.0,
                float((chosen - top2[:, 0]).max()))

    # nearest codes: L2-normalised tokens and table, as the codebook feeds it
    for dtype in (torch.bfloat16, torch.float32):
        z = l2_normalize(randn(n_tok, 32)).to(dtype)
        codes = l2_normalize(randn(8192, 32)).to(dtype)
        idx, idx_p = nearest_codes(z, codes), _nearest_codes_reference(z, codes)
        dist = plain_distances(z, codes)
        agree, worst_gap, excess = index_report(idx, idx_p, dist)
        print(f"[kernel] nearest_codes {dtype}: agreement {agree:.6f}, "
              f"largest gap at a disagreement {worst_gap:.3e} (tol 1e-5), "
              f"chosen-distance excess {excess:.3e} (tol 1e-5)", flush=True)
        if not (worst_gap <= 1e-5 and excess <= 1e-5):
            raise AssertionError("nearest_codes index criterion failed")
        zf, cf = z.float(), codes.float()
        record("nearest_codes", f"z ({n_tok},32) codes (8192,32)", dtype,
               1e-5, excess, excess,
               time_ms(lambda: nearest_codes(z, codes)),
               time_ms(lambda: _nearest_codes_reference(z, codes)),
               time_ms(lambda: torch.cdist(zf, cf).argmin(dim=1)),
               nbytes(z, codes, idx), 2 * n_tok * 8192 * 32,
               metric="chosen-distance excess")

    # nearest codes at the other widths the repaired kernel takes (8: the
    # overfit configs' codebooks; 64: the largest in registers), fp32 with
    # TF32 off: every index equal to the plain version's
    for width in (8, 64):
        z = l2_normalize(randn(n_tok, width))
        codes = l2_normalize(randn(8192, width))
        idx, idx_p = nearest_codes(z, codes), _nearest_codes_reference(z, codes)
        agree, worst_gap, excess = index_report(idx, idx_p,
                                                plain_distances(z, codes))
        gate(agree == 1.0 and excess <= 1e-5,
             f"nearest_codes width {width}: index agreement {agree}")
        record("nearest_codes", f"z ({n_tok},{width}) codes (8192,{width}) "
               f"(index agreement {agree:.6f})", torch.float32, 1e-5, excess,
               excess, time_ms(lambda: nearest_codes(z, codes)),
               time_ms(lambda: _nearest_codes_reference(z, codes)),
               time_ms(lambda: torch.cdist(z, codes).argmin(dim=1)),
               nbytes(z, codes, idx), 2 * n_tok * 8192 * width,
               metric="chosen-distance excess")

    # kernel 4's designs (bf16: the dots on wgmma; fp32: exact FMA dots on
    # register tiles) at the main path's shape: bit-equal on a repeat call
    # and in turns against the faster of two library chains (cdist +
    # argmin; addmm(|e|^2, z, codes^T, alpha=-2) + argmin on fp32
    # operands, TF32 off: the same function for bf16 inputs, whose
    # products are exact in fp32), beside the first design's back-to-back
    # time (PERF.md's table)
    codes_turns = []
    for dtype, before in ((torch.bfloat16, 0.1867), (torch.float32, 0.1875)):
        z = l2_normalize(randn(n_tok, 32)).to(dtype)
        codes = l2_normalize(randn(8192, 32)).to(dtype)
        chains = {
            "cdist+argmin": lambda: torch.cdist(
                z.float(), codes.float()).argmin(dim=1),
            "addmm+argmin": lambda: torch.addmm(
                torch.sum(codes.float() ** 2, dim=-1), z.float(),
                codes.float().T, alpha=-2).argmin(dim=1)}
        chain_ms = {k: device_ms(f) for k, f in chains.items()}
        chain = min(chain_ms, key=chain_ms.get)
        print(f"[kernel] nearest_codes {str(dtype)[6:]} library chains: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in chain_ms.items()),
              flush=True)
        repeat_equal(f"nearest_codes (8192,32) {str(dtype)[6:]}",
                     lambda: [nearest_codes(z, codes)], [nearest_codes(z, codes)])
        codes_turns.append(in_turns(
            4, f"z ({n_tok},32) codes (8192,32) against {chain}",
            lambda: nearest_codes(z, codes), chains[chain], before,
            2 * n_tok * 8192 * 32, peak=str(dtype)[6:]))
    # the other widths: bf16 8, 16 and 64 on wgmma, and width 20, which both
    # dtypes route to the first design (32-wide steps through shared
    # memory): the index criterion of the main shape
    for width, dtype in ((8, torch.bfloat16), (16, torch.bfloat16),
                         (64, torch.bfloat16), (20, torch.bfloat16),
                         (20, torch.float32)):
        z = l2_normalize(randn(n_tok, width)).to(dtype)
        codes = l2_normalize(randn(8192, width)).to(dtype)
        idx, idx_p = nearest_codes(z, codes), _nearest_codes_reference(z, codes)
        agree, worst_gap, excess = index_report(idx, idx_p,
                                                plain_distances(z, codes))
        gate(worst_gap <= 1e-5 and excess <= 1e-5,
             f"nearest_codes width {width} {dtype}: largest gap at a "
             f"disagreement {worst_gap}, chosen-distance excess {excess}")
        zf, cf = z.float(), codes.float()
        record("nearest_codes", f"z ({n_tok},{width}) codes (8192,{width}) "
               f"(index agreement {agree:.6f})", dtype, 1e-5, excess, excess,
               time_ms(lambda: nearest_codes(z, codes)),
               time_ms(lambda: _nearest_codes_reference(z, codes)),
               time_ms(lambda: torch.cdist(zf, cf).argmin(dim=1)),
               nbytes(z, codes, idx), 2 * n_tok * 8192 * width,
               metric="chosen-distance excess")
    # ragged shapes, both dtypes: the overfit micro-step's (32 tokens x 64
    # codes, width 8: one slice writing the indices itself, a last chunk
    # TMA zero-fills), fewer than 128 tokens and codes, a ragged last token
    # tile and chunk, a 65th chunk, and width 20's one slice and two on the
    # first design. fp32 on the new designs: every index equal to the
    # plain version's; else the index criterion
    ragged = []
    for n_z, n_c, width in ((32, 64, 8), (100, 77, 8), (520, 1000, 32),
                            (8192, 8256, 32), (520, 1000, 16),
                            (100, 77, 64), (100, 77, 20), (520, 1000, 20)):
        for dtype in (torch.bfloat16, torch.float32):
            z = l2_normalize(randn(n_z, width)).to(dtype)
            codes = l2_normalize(randn(n_c, width)).to(dtype)
            idx = nearest_codes(z, codes)
            agree, worst_gap, excess = index_report(
                idx, _nearest_codes_reference(z, codes),
                plain_distances(z, codes))
            exact = dtype == torch.float32 and width in (8, 16, 32, 64)
            gate(idx.shape == (n_z,) and (agree == 1.0 if exact else True)
                 and worst_gap <= 1e-5 and excess <= 1e-5,
                 f"nearest_codes ({n_z},{width}) x {n_c} {dtype}: agreement "
                 f"{agree}, largest gap at a disagreement {worst_gap}, "
                 f"chosen-distance excess {excess}")
            ragged.append(f"({n_z},{width})x{n_c} {str(dtype)[6:]} {agree:.6f}")
    print("[kernel] nearest_codes ragged shapes, index agreement: "
          + "; ".join(ragged), flush=True)
    del z, codes, zf, cf

    # a LayerNorm row past the register path (d 8192: the block-a-row loop)
    xw = randn(1024, 8192, dtype=torch.bfloat16, scale=2.0, shift=0.5)
    gw = randn(8192, scale=0.1, shift=1.0)
    got, want = layernorm(xw, gw), _ln_reference(xw, gw, None, 1e-5)
    record("layernorm", "(1024,8192) no beta, row loop", torch.bfloat16,
           BF16_TOL, rel_l2(got, want), max_abs(got, want),
           time_ms(lambda: layernorm(xw, gw)),
           time_ms(lambda: _ln_reference(xw, gw, None, 1e-5)),
           time_ms(lambda: F.layer_norm(xw, (8192,), gw.to(torch.bfloat16))),
           nbytes(xw, xw, gw), 8 * xw.numel())
    gw_b = gw.to(torch.bfloat16)
    ln_turns.append(in_turns(
        3, "(1024,8192) no beta, row loop", lambda: layernorm(xw, gw),
        lambda: F.layer_norm(xw, (8192,), gw_b), 0.0243, 8 * xw.numel(),
        bytes_moved=nbytes(xw, xw, gw)))
    del xw, got, want

    # backward kernels, bf16 and fp32, causal and not, at the main path's
    # shapes; the library call is SDPA's forward + backward
    scale = d_ ** -0.5
    for dtype, causal, hh in ((torch.bfloat16, False, h_),
                              (torch.float32, False, h_),
                              (torch.bfloat16, True, h_),
                              (torch.float32, True, h_),
                              (torch.bfloat16, False, mg_heads),
                              (torch.float32, False, mg_heads)):
        q = randn(b_, t_, hh, d_, dtype=dtype)
        kv = randn(b_, t_, 2, hh, d_, dtype=dtype)
        out, lse = flash_attention_bthd_kv(q, kv, causal=causal)
        g = randn(b_, t_, hh, d_, dtype=dtype)
        dq, dkv = flash_attention_bwd_kv(q, kv, out, lse, g, scale=scale,
                                         causal=causal)
        dq_p, dkv_p = _flash_backward_reference(q, kv, out, lse, g, scale,
                                                causal)
        pairs = [(dq, dq_p), (dkv[:, :, 0], dkv_p[:, :, 0]),
                 (dkv[:, :, 1], dkv_p[:, :, 1])]
        errs = [rel_l2(a, b) for a, b in pairs]
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, kv[:, :, 0], kv[:, :, 1]))
        gs = g.transpose(1, 2).contiguous()

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
            return torch.autograd.grad(o, (qs, ks, vs), gs)

        n_pairs = t_ * (t_ + 1) // 2 if causal else t_ * t_
        record("flash_attention_bwd_kv",
               f"b{b_} t{t_} h{hh} d{d_} causal={causal} (dq, dk, dv rel_l2 "
               f"{errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e})", dtype,
               BWD_BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
               max(errs), max(max_abs(a, b) for a, b in pairs),
               time_ms(lambda: flash_attention_bwd_kv(
                   q, kv, out, lse, g, scale=scale, causal=causal)),
               time_ms(lambda: _flash_backward_reference(
                   q, kv, out, lse, g, scale, causal)),
               time_ms(sdpa_fwd_bwd),
               nbytes(q, kv, out, lse, g, dq, dkv),
               10 * b_ * hh * d_ * n_pairs)

    # kernels 9 and 10: separate k and v on (b, t, h, d) at the recon shape
    # (b 8, t 1024, h 8) and at h 12, bf16 and fp32, causal and not, tq != tk
    # once, head width 64 and 32; kernels 16, 17 and 18 on (b, h, t, d) at
    # the long-context shape (b 1, h 8, t 4096), the same variants. The
    # library call is SDPA (forward for 9 and 16, forward + backward for 10
    # and for 17 + 18); its causal mask is top-left, so at tq != tk it takes
    # the bottom-right mask explicitly
    def pairs_of(tq, tk, causal):
        """the (query, key) pairs a causal bottom-right mask leaves visible"""
        return tq * (tk - tq) + tq * (tq + 1) // 2 if causal else tq * tk

    def sdpa(qh, kh, vh, causal):
        tq, tk = qh.shape[2], kh.shape[2]
        if causal and tq != tk:
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=~make_causal_mask(tq, tk, dev))
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

    def sdpa_fwd_bwd_of(qh, kh, vh, gh, causal):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (qh, kh, vh)]

        def run():
            return torch.autograd.grad(sdpa(*leaves, causal), leaves, gh)
        return run

    def tol_of(dtype, backward=False):
        if dtype == torch.float32:
            return F32_TOL
        return BWD_BF16_TOL if backward else BF16_TOL

    def heads(t):
        return t.transpose(1, 2)

    for bb, tq, tk, hh, dd, dtype, causal in (
            (b_, t_, t_, h_, d_, torch.bfloat16, False),
            (b_, t_, t_, h_, d_, torch.float32, False),
            (b_, t_, t_, h_, d_, torch.bfloat16, True),
            (b_, t_, t_, h_, d_, torch.float32, True),
            (b_, t_, t_, mg_heads, d_, torch.bfloat16, False),
            (b_, t_, t_, mg_heads, d_, torch.float32, False),
            (b_, t_ // 2, t_, h_, d_, torch.bfloat16, True),
            (b_, t_ // 2, t_, h_, d_, torch.float32, True),
            (b_, t_, t_, h_, 32, torch.bfloat16, False),
            (b_, t_, t_, h_, 32, torch.float32, True)):
        sc = dd ** -0.5
        q, k, v, g = (randn(bb, t, hh, dd, dtype=dtype)
                      for t in (tq, tk, tk, tq))
        out, lse = flash_attention_bthd(q, k, v, causal=causal)
        out_p, lse_p = _flash_bthd_reference(q, k, v, sc, causal)
        tol = tol_of(dtype)
        lse_err = rel_l2(lse, lse_p)
        gate(lse_err <= tol, f"flash_attention_bthd lse rel_l2 {lse_err}")
        qs, ks, vs, gs = (heads(t).contiguous() for t in (q, k, v, g))
        npairs = pairs_of(tq, tk, causal)
        label = f"b{bb} tq{tq} tk{tk} h{hh} d{dd} causal={causal}"
        record("flash_attention_bthd", f"{label} (lse rel_l2 {lse_err:.2e})",
               dtype, tol, rel_l2(out, out_p), max_abs(out, out_p),
               time_ms(lambda: flash_attention_bthd(q, k, v, causal=causal)),
               time_ms(lambda: _flash_bthd_reference(q, k, v, sc, causal)),
               time_ms(lambda: sdpa(qs, ks, vs, causal)),
               nbytes(q, k, v, out, lse), 4 * bb * hh * dd * npairs)
        grads = flash_attention_bwd_bthd(q, k, v, out, lse, g, scale=sc,
                                         causal=causal)
        grads_p = _flash_backward_bthd_reference(q, k, v, out, lse, g, sc,
                                                 causal)
        errs = [rel_l2(a, b) for a, b in zip(grads, grads_p)]
        record("flash_attention_bwd_bthd",
               f"{label} (dq, dk, dv rel_l2 {errs[0]:.2e}, {errs[1]:.2e}, "
               f"{errs[2]:.2e})", dtype, tol_of(dtype, True), max(errs),
               max(max_abs(a, b) for a, b in zip(grads, grads_p)),
               time_ms(lambda: flash_attention_bwd_bthd(
                   q, k, v, out, lse, g, scale=sc, causal=causal)),
               time_ms(lambda: _flash_backward_bthd_reference(
                   q, k, v, out, lse, g, sc, causal), iters=5),
               time_ms(sdpa_fwd_bwd_of(qs, ks, vs, gs, causal)),
               nbytes(q, k, v, out, lse, g, *grads),
               10 * bb * hh * dd * npairs)
        del q, k, v, g, out, lse, grads, grads_p, qs, ks, vs, gs

    lt = 4096
    for tq, tk, dd, dtype, causal in ((lt, lt, d_, torch.bfloat16, True),
                                      (lt, lt, d_, torch.bfloat16, False),
                                      (lt, lt, d_, torch.float32, True),
                                      (lt, lt, d_, torch.float32, False),
                                      (lt // 2, lt, d_, torch.bfloat16, True),
                                      (lt, lt, 32, torch.bfloat16, True),
                                      (lt, lt, 32, torch.float32, True)):
        sc = dd ** -0.5
        q, k, v, g = (randn(1, h_, t, dd, dtype=dtype)
                      for t in (tq, tk, tk, tq))
        main = (tq, dd, dtype, causal) == (lt, d_, torch.bfloat16, True)
        out, lse = flash_forward(q, k, v, scale=sc, causal=causal)
        out_p, lse_p = _flash_forward_reference(q, k, v, sc, causal)
        tol = tol_of(dtype)
        lse_err = rel_l2(lse, lse_p)
        gate(lse_err <= tol, f"flash_forward lse rel_l2 {lse_err}")
        npairs = pairs_of(tq, tk, causal)
        label = f"b1 tq{tq} tk{tk} h{h_} d{dd} causal={causal}"
        record("flash_forward", f"{label} (lse rel_l2 {lse_err:.2e})", dtype,
               tol, rel_l2(out, out_p), max_abs(out, out_p),
               time_ms(lambda: flash_forward(q, k, v, scale=sc,
                                             causal=causal)),
               time_ms(lambda: _flash_forward_reference(q, k, v, sc, causal),
                       iters=5),
               time_ms(lambda: sdpa(q, k, v, causal)),
               nbytes(q, k, v, out, lse), 4 * h_ * dd * npairs, main=main)
        delta = flash_delta(out, g)
        dk, dv = flash_bwd_dkv(q, g, lse, delta, k, v, scale=sc,
                               causal=causal)
        dq = flash_bwd_dq(k, v, q, g, lse, delta, scale=sc, causal=causal)
        dk_p, dv_p = _flash_bwd_dkv_reference(q, g, lse, delta, k, v, sc,
                                              causal)
        dq_p = _flash_bwd_dq_reference(k, v, q, g, lse, delta, sc, causal)
        lib_ms = time_ms(sdpa_fwd_bwd_of(q, k, v, g, causal))
        errs = [rel_l2(dk, dk_p), rel_l2(dv, dv_p)]
        record("flash_bwd_dkv",
               f"{label} (dk, dv rel_l2 {errs[0]:.2e}, {errs[1]:.2e})",
               dtype, tol_of(dtype, True), max(errs),
               max(max_abs(dk, dk_p), max_abs(dv, dv_p)),
               time_ms(lambda: flash_bwd_dkv(q, g, lse, delta, k, v,
                                             scale=sc, causal=causal)),
               time_ms(lambda: _flash_bwd_dkv_reference(
                   q, g, lse, delta, k, v, sc, causal), iters=5),
               lib_ms, nbytes(q, k, v, g, lse, delta, dk, dv),
               8 * h_ * dd * npairs, main=main)
        record("flash_bwd_dq", label, dtype, tol_of(dtype, True),
               rel_l2(dq, dq_p), max_abs(dq, dq_p),
               time_ms(lambda: flash_bwd_dq(k, v, q, g, lse, delta,
                                            scale=sc, causal=causal)),
               time_ms(lambda: _flash_bwd_dq_reference(
                   k, v, q, g, lse, delta, sc, causal), iters=5),
               lib_ms, nbytes(q, k, v, g, lse, delta, dq),
               6 * h_ * dd * npairs, main=main)
        del q, k, v, g, out, lse, delta, dk, dv, dq, dk_p, dv_p, dq_p

    # one template, three layouts: bit for bit, kernel 9 on the views
    # kv[:, :, 0], kv[:, :, 1] is kernel 1 on the packed kv and kernel 10 is
    # kernel 5; kernel 16 on the (b, h, t, d) transposes is kernel 9, and
    # kernels 17 and 18 there are kernel 10
    for dtype, causal in ((torch.bfloat16, False), (torch.float32, True)):
        q = randn(b_, t_, h_, d_, dtype=dtype)
        kv = randn(b_, t_, 2, h_, d_, dtype=dtype)
        g = randn(b_, t_, h_, d_, dtype=dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
        o1, l1 = flash_attention_bthd_kv(q, kv, causal=causal)
        o9, l9 = flash_attention_bthd(q, k, v, causal=causal)
        dq5, dkv5 = flash_attention_bwd_kv(q, kv, o1, l1, g, scale=scale,
                                           causal=causal)
        dq10, dk10, dv10 = flash_attention_bwd_bthd(
            q, k, v, o9, l9, g, scale=scale, causal=causal)
        o16, l16 = flash_forward(heads(q), heads(k), heads(v), scale=scale,
                                 causal=causal)
        delta = flash_delta(o16, heads(g))
        dk17, dv17 = flash_bwd_dkv(heads(q), heads(g), l16, delta, heads(k),
                                   heads(v), scale=scale, causal=causal)
        dq18 = flash_bwd_dq(heads(k), heads(v), heads(q), heads(g), l16,
                            delta, scale=scale, causal=causal)
        same = {
            "9 = 1": torch.equal(o9, o1) and torch.equal(l9, l1),
            "10 = 5": (torch.equal(dq10, dq5)
                       and torch.equal(dk10, dkv5[:, :, 0])
                       and torch.equal(dv10, dkv5[:, :, 1])),
            "16 = 9": (torch.equal(heads(o16), o9)
                       and torch.equal(heads(l16), l9)),
            "17 + 18 = 10": (torch.equal(heads(dq18), dq10)
                             and torch.equal(heads(dk17), dk10)
                             and torch.equal(heads(dv17), dv10))}
        print(f"[kernel] flash layouts, {str(dtype)[6:]} causal={causal}, "
              f"bit for bit: {same}", flush=True)
        gate(all(same.values()), f"flash layouts differ: {same}")
        if dtype == torch.float32:  # the register-tiled forward
            repeat_equal("flash forward fp32 causal (kernel 1)",
                         lambda: flash_attention_bthd_kv(q, kv, causal=causal),
                         (o1, l1))
            repeat_equal("flash forward fp32 causal (kernel 16)",
                         lambda: flash_forward(heads(q), heads(k), heads(v),
                                               scale=scale, causal=causal),
                         (o16, l16))
        del q, kv, g, k, v, o1, l1, o9, l9, dq5, dkv5, dq10, dk10, dv10
        del o16, l16, delta, dk17, dv17, dq18

    # the forward at a ragged length (b 2, h 8, t 1096: the last q and k/v
    # tiles partly past t, zero-filled and never stored) through kernels 16
    # and 1, and at head width 32 on the recon shape through kernel 1, causal
    # and not, bf16 and fp32, against the plain versions
    bf, f32 = torch.bfloat16, torch.float32
    for kernel, bb, tt, dd, causal, fdt in (
            ("flash_forward", 2, 1096, d_, False, bf),
            ("flash_forward", 2, 1096, d_, True, bf),
            ("flash_attention_bthd_kv", 2, 1096, d_, False, bf),
            ("flash_attention_bthd_kv", 2, 1096, d_, True, bf),
            ("flash_attention_bthd_kv", b_, t_, 32, False, bf),
            ("flash_attention_bthd_kv", b_, t_, 32, True, bf),
            ("flash_forward", 2, 1096, d_, False, f32),
            ("flash_forward", 2, 1096, d_, True, f32),
            ("flash_attention_bthd_kv", 2, 1096, d_, True, f32),
            ("flash_attention_bthd_kv", 2, 1096, 32, False, f32),
            ("flash_attention_bthd_kv", b_, t_, 32, False, f32)):
        sc = dd ** -0.5
        ftol = tol_of(fdt)
        if kernel == "flash_forward":
            q, k, v = (randn(bb, h_, tt, dd, dtype=fdt) for _ in range(3))
            out, lse = flash_forward(q, k, v, scale=sc, causal=causal)
            out_p, lse_p = _flash_forward_reference(q, k, v, sc, causal)
            run = lambda: flash_forward(q, k, v, scale=sc,  # noqa: E731
                                        causal=causal)
            plain = lambda: _flash_forward_reference(  # noqa: E731
                q, k, v, sc, causal)
            qs, ks, vs = q, k, v
            moved = nbytes(q, k, v, out, lse)
        else:
            q = randn(bb, tt, h_, dd, dtype=fdt)
            kv = randn(bb, tt, 2, h_, dd, dtype=fdt)
            out, lse = flash_attention_bthd_kv(q, kv, causal=causal)
            out_p, lse_p = _flash_reference(q, kv, sc, causal)
            run = lambda: flash_attention_bthd_kv(  # noqa: E731
                q, kv, causal=causal)
            plain = lambda: _flash_reference(q, kv, sc, causal)  # noqa: E731
            qs, ks, vs = (heads(t).contiguous()
                          for t in (q, kv[:, :, 0], kv[:, :, 1]))
            moved = nbytes(q, kv, out, lse)
        lse_err = rel_l2(lse, lse_p)
        gate(lse_err <= ftol, f"{kernel} t {tt} d {dd} lse rel_l2 "
             f"{lse_err}")
        gate(bool(torch.isfinite(out).all()), f"{kernel} t {tt}: non-finite")
        record(kernel, f"b{bb} t{tt} h{h_} d{dd} causal={causal} "
               f"(lse rel_l2 {lse_err:.2e})", fdt, ftol,
               rel_l2(out, out_p), max_abs(out, out_p), time_ms(run),
               time_ms(plain, iters=5), time_ms(lambda: sdpa(qs, ks, vs,
                                                             causal)),
               moved, 4 * bb * h_ * dd * pairs_of(tt, tt, causal))
    q = k = v = kv = out = lse = out_p = lse_p = qs = ks = vs = None

    # the bf16 backward at the ragged length (b 2, h 8, t 1096: the last q
    # and k/v tiles of 64 partly past t, zero-filled by TMA; rows past tq
    # read lse = +inf) through kernels 17 + 18 and 5, and at head width 32
    # on the recon shape through kernel 5, causal and not, against the plain
    # versions (2e-2), every output finite
    for kernel, bb, tt, dd, causal in (
            ("flash_bwd", 2, 1096, d_, False),
            ("flash_bwd", 2, 1096, d_, True),
            ("flash_attention_bwd_kv", 2, 1096, d_, False),
            ("flash_attention_bwd_kv", 2, 1096, d_, True),
            ("flash_attention_bwd_kv", b_, t_, 32, False),
            ("flash_attention_bwd_kv", b_, t_, 32, True)):
        sc = dd ** -0.5
        label = f"b{bb} t{tt} h{h_} d{dd} causal={causal}"
        npairs = pairs_of(tt, tt, causal)
        if kernel == "flash_bwd":
            q, k, v, g = (randn(bb, h_, tt, dd, dtype=torch.bfloat16)
                          for _ in range(4))
            out, lse = flash_forward(q, k, v, scale=sc, causal=causal)
            delta = flash_delta(out, g)
            dk, dv = flash_bwd_dkv(q, g, lse, delta, k, v, scale=sc,
                                   causal=causal)
            dq = flash_bwd_dq(k, v, q, g, lse, delta, scale=sc,
                              causal=causal)
            dk_p, dv_p = _flash_bwd_dkv_reference(q, g, lse, delta, k, v, sc,
                                                  causal)
            dq_p = _flash_bwd_dq_reference(k, v, q, g, lse, delta, sc,
                                           causal)
            lib_ms = time_ms(sdpa_fwd_bwd_of(q, k, v, g, causal))
            errs = [rel_l2(dk, dk_p), rel_l2(dv, dv_p)]
            gate(all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv)),
                 f"flash backward {label}: non-finite")
            record("flash_bwd_dkv", f"{label} (dk, dv rel_l2 {errs[0]:.2e}, "
                   f"{errs[1]:.2e})", torch.bfloat16, BWD_BF16_TOL,
                   max(errs), max(max_abs(dk, dk_p), max_abs(dv, dv_p)),
                   time_ms(lambda: flash_bwd_dkv(q, g, lse, delta, k, v,
                                                 scale=sc, causal=causal)),
                   time_ms(lambda: _flash_bwd_dkv_reference(
                       q, g, lse, delta, k, v, sc, causal), iters=5),
                   lib_ms, nbytes(q, k, v, g, lse, delta, dk, dv),
                   8 * bb * h_ * dd * npairs)
            record("flash_bwd_dq", label, torch.bfloat16, BWD_BF16_TOL,
                   rel_l2(dq, dq_p), max_abs(dq, dq_p),
                   time_ms(lambda: flash_bwd_dq(k, v, q, g, lse, delta,
                                                scale=sc, causal=causal)),
                   time_ms(lambda: _flash_bwd_dq_reference(
                       k, v, q, g, lse, delta, sc, causal), iters=5),
                   lib_ms, nbytes(q, k, v, g, lse, delta, dq),
                   6 * bb * h_ * dd * npairs)
            del q, k, v, g, out, lse, delta, dk, dv, dq, dk_p, dv_p, dq_p
            continue
        q = randn(bb, tt, h_, dd, dtype=torch.bfloat16)
        kv = randn(bb, tt, 2, h_, dd, dtype=torch.bfloat16)
        g = randn(bb, tt, h_, dd, dtype=torch.bfloat16)
        out, lse = flash_attention_bthd_kv(q, kv, causal=causal)
        dq, dkv = flash_attention_bwd_kv(q, kv, out, lse, g, scale=sc,
                                         causal=causal)
        dq_p, dkv_p = _flash_backward_reference(q, kv, out, lse, g, sc,
                                                causal)
        errs = [rel_l2(dq, dq_p), rel_l2(dkv[:, :, 0], dkv_p[:, :, 0]),
                rel_l2(dkv[:, :, 1], dkv_p[:, :, 1])]
        gate(all(bool(torch.isfinite(x).all()) for x in (dq, dkv)),
             f"flash_attention_bwd_kv {label}: non-finite")
        record("flash_attention_bwd_kv", f"{label} (dq, dk, dv rel_l2 "
               f"{errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e})",
               torch.bfloat16, BWD_BF16_TOL, max(errs),
               max(max_abs(dq, dq_p), max_abs(dkv, dkv_p)),
               time_ms(lambda: flash_attention_bwd_kv(
                   q, kv, out, lse, g, scale=sc, causal=causal)),
               time_ms(lambda: _flash_backward_reference(
                   q, kv, out, lse, g, sc, causal), iters=5),
               time_ms(sdpa_fwd_bwd_of(*(heads(t).contiguous() for t in (
                   q, kv[:, :, 0], kv[:, :, 1], g)), causal)),
               nbytes(q, kv, out, lse, g, dq, dkv), 10 * bb * h_ * dd * npairs)
        del q, kv, g, out, lse, dq, dkv, dq_p, dkv_p

    # the forward against SDPA in turns (kernel, SDPA, SDPA, kernel) at the
    # shapes of the kernels' table, beside the ratio of the kernel it
    # replaced (same shapes, same card type; bf16: the mma.sync kernel's,
    # fp32: the one-thread-a-row kernel's kernel / SDPA, None where PERF.md
    # has no reading): device time (launches queued behind a sleep), then
    # back to back as a caller enqueues them (host time included where it
    # exceeds the card's). fp32 runs with TF32 off, SDPA's included
    fwd_vs_sdpa = []
    for row, bb, hh, tt, causal, before, fdt in (
            (1, b_, h_, t_, False, 2.65, bf),
            (1, b_, mg_heads, t_, False, 2.86, bf),
            (1, 16, 16, t_, False, 2.98, bf), (9, b_, h_, t_, False, 2.81, bf),
            (16, 1, h_, 4096, True, 3.40, bf),
            (16, 1, h_, 4096, False, 2.91, bf),
            (16, 1, h_, 16384, True, 3.17, bf),
            (1, b_, h_, t_, False, 1.775, f32),
            (1, b_, mg_heads, t_, False, None, f32),
            (9, b_, h_, t_, False, 1.785, f32),
            (9, b_, mg_heads, t_, False, None, f32),
            (16, 1, h_, 4096, True, 2.151, f32),
            (16, 1, h_, 4096, False, None, f32)):
        if row == 16:
            q, k, v = (randn(bb, hh, tt, d_, dtype=fdt) for _ in range(3))
            qs, ks, vs = q, k, v
            run = lambda: flash_forward(q, k, v, scale=scale,  # noqa: E731
                                        causal=causal)
        else:
            q = randn(bb, tt, hh, d_, dtype=fdt)
            kv = randn(bb, tt, 2, hh, d_, dtype=fdt)
            k, v = kv[:, :, 0], kv[:, :, 1]
            qs, ks, vs = (heads(t).contiguous() for t in (q, k, v))
            run = ((lambda: flash_attention_bthd_kv(q, kv, causal=causal))
                   if row == 1 else
                   (lambda: flash_attention_bthd(q, k, v, causal=causal)))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qs, ks, vs, is_causal=causal)
        k1, s1, s2, k2 = (device_ms(run), device_ms(lib), device_ms(lib),
                          device_ms(run))
        bk1, bs1, bs2, bk2 = (time_ms(run), time_ms(lib), time_ms(lib),
                              time_ms(run))
        ratio = (k1 + k2) / (s1 + s2)
        fname = str(fdt).split(".")[-1]
        b_ms = bound(0, [(4 * bb * hh * d_ * pairs_of(tt, tt, causal),
                          fname)])[0]
        r = dict(row=row, b=bb, h=hh, t=tt, causal=causal, dtype=fname,
                 kernel_ms=(k1 + k2) / 2, sdpa_ms=(s1 + s2) / 2, ratio=ratio,
                 back_to_back_kernel_ms=(bk1 + bk2) / 2,
                 back_to_back_sdpa_ms=(bs1 + bs2) / 2,
                 back_to_back_ratio=(bk1 + bk2) / (bs1 + bs2),
                 before_ratio=before, bound_ms=b_ms)
        fwd_vs_sdpa.append(r)
        print(f"[turns] kernel {row} b{bb} h{hh} t{tt} {fname} "
              f"causal={causal}: device kernel {k1:.4f} / {k2:.4f} ms, SDPA "
              f"{s1:.4f} / {s2:.4f} ms, kernel/SDPA {ratio:.3f} (the kernel "
              f"it replaced {before}); back to back {bk1:.4f} / {bk2:.4f} "
              f"against {bs1:.4f} / {bs2:.4f}, "
              f"{r['back_to_back_ratio']:.3f}; bound {b_ms:.4f} ms "
              f"({100 * b_ms / r['kernel_ms']:.1f} % of it)", flush=True)
    q = k = v = kv = qs = ks = vs = None
    # host cost of one forward call at Muse's shape (plan lookup, three
    # tensor maps encoded, the launch): enqueue time of 200 calls
    q = randn(16, t_, 16, d_, dtype=torch.bfloat16)
    kv = randn(16, t_, 2, 16, d_, dtype=torch.bfloat16)
    flash_attention_bthd_kv(q, kv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        flash_attention_bthd_kv(q, kv)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"[host] flash_attention_bthd_kv b16 t{t_} h16: {host_us:.1f} us "
          f"a call on the host (enqueue)", flush=True)
    del q, kv

    # the backward (dkv + dq, and delta = rowsum(o * dout) before them)
    # against SDPA's forward + backward in turns (kernel, SDPA, SDPA,
    # kernel) at the shapes of the kernels' table, bf16 and fp32, beside
    # the ratio of the kernels it replaced (PERF.md, same shapes, same card
    # type): device time, then back to back; kernels 17 and 18 also alone.
    # The bound counts the split's 14 flops a visible pair (10 for the
    # fused TPU kernel's five products beside it)
    bwd_vs_sdpa = []
    for row, bb, hh, tt, dtype, causal, before in (
            (5, b_, h_, t_, torch.bfloat16, False, 2.17),
            (5, b_, mg_heads, t_, torch.bfloat16, False, 2.42),
            (5, b_, h_, t_, torch.float32, False, 3.85),
            (5, b_, mg_heads, t_, torch.float32, False, 3.84),
            (10, b_, h_, t_, torch.bfloat16, False, 2.63),
            (10, b_, h_, t_, torch.float32, False, 3.90),
            (17, 1, h_, 4096, torch.bfloat16, True, 1.72),
            (17, 1, h_, 4096, torch.bfloat16, False, 3.03),
            (17, 1, h_, 4096, torch.float32, True, 6.39),
            (17, 1, h_, 16384, torch.bfloat16, True, 3.87)):
        if row == 17:
            q, k, v, g = (randn(bb, hh, tt, d_, dtype=dtype)
                          for _ in range(4))
            out, lse = flash_forward(q, k, v, scale=scale, causal=causal)
            qs, ks, vs, gs = q, k, v, g
            run = lambda: flash_mod._flash_backward(  # noqa: E731
                q, k, v, out, lse, g, scale=scale, causal=causal)
            delta = flash_delta(out, g)
            parts = dict(
                dkv=device_ms(lambda: flash_bwd_dkv(
                    q, g, lse, delta, k, v, scale=scale, causal=causal)),
                dq=device_ms(lambda: flash_bwd_dq(
                    k, v, q, g, lse, delta, scale=scale, causal=causal)))
        else:
            q, g = (randn(bb, tt, hh, d_, dtype=dtype) for _ in range(2))
            kv = randn(bb, tt, 2, hh, d_, dtype=dtype)
            k, v = kv[:, :, 0], kv[:, :, 1]
            out, lse = flash_attention_bthd_kv(q, kv, causal=causal)
            qs, ks, vs, gs = (heads(t).contiguous() for t in (q, k, v, g))
            run = ((lambda: flash_attention_bwd_kv(
                q, kv, out, lse, g, scale=scale, causal=causal))
                if row == 5 else
                (lambda: flash_attention_bwd_bthd(
                    q, k, v, out, lse, g, scale=scale, causal=causal)))
            parts = {}
        lib = sdpa_fwd_bwd_of(qs, ks, vs, gs, causal)
        k1, s1, s2, k2 = (device_ms(run), device_ms(lib), device_ms(lib),
                          device_ms(run))
        bk1, bs1, bs2, bk2 = (time_ms(run), time_ms(lib), time_ms(lib),
                              time_ms(run))
        ratio = (k1 + k2) / (s1 + s2)
        npairs = bb * hh * d_ * pairs_of(tt, tt, causal)
        peak = str(dtype).split(".")[-1]
        b14 = bound(0, [(14 * npairs, peak)])[0]
        b10 = bound(0, [(10 * npairs, peak)])[0]
        r = dict(row=row, b=bb, h=hh, t=tt, dtype=peak, causal=causal,
                 kernel_ms=(k1 + k2) / 2, sdpa_ms=(s1 + s2) / 2, ratio=ratio,
                 back_to_back_kernel_ms=(bk1 + bk2) / 2,
                 back_to_back_sdpa_ms=(bs1 + bs2) / 2,
                 back_to_back_ratio=(bk1 + bk2) / (bs1 + bs2),
                 before_ratio=before, bound_ms=b14, bound10_ms=b10,
                 **{f"{n}_ms": t for n, t in parts.items()})
        bwd_vs_sdpa.append(r)
        alone = "".join(f", {n} alone {t:.4f} ms" for n, t in parts.items())
        print(f"[turns] backward {row if row != 17 else '17 + 18'} b{bb} "
              f"h{hh} t{tt} {peak} causal={causal}: device kernel "
              f"{k1:.4f} / {k2:.4f} ms, SDPA fwd+bwd {s1:.4f} / {s2:.4f} ms, "
              f"kernel/SDPA {ratio:.3f} (before {before}){alone}; back to "
              f"back {bk1:.4f} / {bk2:.4f} against {bs1:.4f} / {bs2:.4f}, "
              f"{r['back_to_back_ratio']:.3f}; bound {b14:.4f} ms, 14 flops "
              f"a pair ({100 * b14 / r['kernel_ms']:.1f} % of it; 10 flops "
              f"{b10:.4f})", flush=True)
        del q, k, v, g, out, lse, qs, ks, vs, gs, run, lib
    del kv, delta

    # fused LN + MLP backward, bf16; the library call is layer_norm ->
    # linear -> gelu -> linear forward + backward
    dy = randn(n_tok, dim, dtype=torch.bfloat16)
    bwd_args = (x, lng, lnb, w1, b1, w2, dy)
    got = fused_ln_mlp_backward(*bwd_args)
    want = _ln_mlp_backward_reference(*bwd_args, 1e-5)
    names = ("dx", "dlng", "dlnb", "dw1", "db1", "dw2", "db2")
    errs = {k: rel_l2(a, b) for k, a, b in zip(names, got, want)}
    lib_leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, lng_b, lnb_b, w1, b1, w2, b2)]

    def ln_mlp_library_fwd_bwd():
        xl, gl, bl, w1l, b1l, w2l, b2l = lib_leaves
        h = F.linear(F.layer_norm(xl, (dim,), gl, bl), w1l, b1l)
        y = xl + F.linear(F.gelu(h), w2l, b2l)
        return torch.autograd.grad(y, lib_leaves, dy)

    record("ln_mlp_bwd", f"({n_tok},{dim}) hid {hid} (" + ", ".join(
               f"{k} {v:.2e}" for k, v in errs.items()) + ")",
           torch.bfloat16, BWD_BF16_TOL, max(errs.values()),
           max(max_abs(a, b) for a, b in zip(got, want)),
           time_ms(lambda: fused_ln_mlp_backward(*bwd_args)),
           time_ms(lambda: _ln_mlp_backward_reference(*bwd_args, 1e-5)),
           time_ms(ln_mlp_library_fwd_bwd),
           nbytes(x, lng, lnb, w1, b1, w2, dy, *got), 10 * n_tok * dim * hid)
    repeat_equal("ln_mlp_bwd", lambda: fused_ln_mlp_backward(*bwd_args), got)
    bwd_turns.append(in_turns(
        6, f"({n_tok},{dim}) hid {hid}",
        lambda: fused_ln_mlp_backward(*bwd_args), ln_mlp_library_fwd_bwd,
        0.9782, 10 * n_tok * dim * hid))

    # kernel 6 at ragged rows (n 520 = 4 x 128 + 8: the last row tile of
    # every product masked, the weight gradients' last K range short)
    rargs = (x[:520], lng, lnb, w1, b1, w2, dy[:520])
    got = fused_ln_mlp_backward(*rargs)
    want = _ln_mlp_backward_reference(*rargs, 1e-5)
    errs = {k: rel_l2(a, b) for k, a, b in zip(names, got, want)}
    rleaves = [lib_leaves[0][:520].detach().clone().requires_grad_(True),
               *lib_leaves[1:]]

    def ragged_library_fwd_bwd():
        xl, gl, bl, w1l, b1l, w2l, b2l = rleaves
        h = F.linear(F.layer_norm(xl, (dim,), gl, bl), w1l, b1l)
        y = xl + F.linear(F.gelu(h), w2l, b2l)
        return torch.autograd.grad(y, rleaves, dy[:520])

    record("ln_mlp_bwd", f"(520,{dim}) hid {hid} ragged rows (" + ", ".join(
               f"{k} {v:.2e}" for k, v in errs.items()) + ")",
           torch.bfloat16, BWD_BF16_TOL, max(errs.values()),
           max(max_abs(a, b) for a, b in zip(got, want)),
           time_ms(lambda: fused_ln_mlp_backward(*rargs)),
           time_ms(lambda: _ln_mlp_backward_reference(*rargs, 1e-5)),
           time_ms(ragged_library_fwd_bwd),
           nbytes(*rargs, *got), 10 * 520 * dim * hid)
    del rargs, rleaves

    # the fused LN + MLP at wider widths: d 768 and 1024 with the ViTVQGAN
    # hidden width of a 4x MLP (2048, 2728), 8 x 1024 rows, forward and
    # backward, bf16; the library chains as above
    for wd, wh, before in ((768, 2048, 1.0944), (1024, 2728, 1.7149)):
        x = randn(n_tok, wd, dtype=torch.bfloat16)
        lg_, lb_ = randn(wd, scale=0.1, shift=1.0), randn(wd, scale=0.1)
        w1 = randn(wh, wd, dtype=torch.bfloat16, scale=wd ** -0.5)
        b1 = randn(wh, scale=0.1)
        w2 = randn(wd, wh, dtype=torch.bfloat16, scale=wh ** -0.5)
        b2 = randn(wd, scale=0.1)
        wargs = (x, lg_, lb_, w1, b1, w2, b2)
        got, want = fused_ln_mlp(*wargs), _ln_mlp_reference(*wargs, 1e-5)
        mlp_err = rel_l2(got.float() - x.float(), want.float() - x.float())
        lgb, lbb, b1b, b2b = (t.to(torch.bfloat16) for t in (lg_, lb_, b1, b2))

        def wide_library():
            h = F.linear(F.layer_norm(x, (wd,), lgb, lbb), w1, b1b)
            return x + F.linear(F.gelu(h), w2, b2b)

        record("ln_mlp", f"({n_tok},{wd}) hid {wh} (MLP part "
               f"rel_l2 {mlp_err:.2e})", torch.bfloat16, BF16_TOL,
               rel_l2(got, want), max_abs(got, want),
               time_ms(lambda: fused_ln_mlp(*wargs)),
               time_ms(lambda: _ln_mlp_reference(*wargs, 1e-5)),
               time_ms(wide_library), nbytes(x, x, lg_, lb_, w1, b1, w2, b2),
               4 * n_tok * wd * wh)
        gate(mlp_err <= 2e-2, f"ln_mlp d {wd} MLP part: {mlp_err}")
        dy = randn(n_tok, wd, dtype=torch.bfloat16)
        wbwd = (x, lg_, lb_, w1, b1, w2, dy)
        got = fused_ln_mlp_backward(*wbwd)
        want = _ln_mlp_backward_reference(*wbwd, 1e-5)
        errs = {k: rel_l2(a, b) for k, a, b in zip(names, got, want)}
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, lgb, lbb, w1, b1b, w2, b2b)]

        def wide_library_fwd_bwd():
            xl, gl, bl, w1l, b1l, w2l, b2l = leaves
            h = F.linear(F.layer_norm(xl, (wd,), gl, bl), w1l, b1l)
            y = xl + F.linear(F.gelu(h), w2l, b2l)
            return torch.autograd.grad(y, leaves, dy)

        record("ln_mlp_bwd", f"({n_tok},{wd}) hid {wh} (" + ", ".join(
                   f"{k} {v:.2e}" for k, v in errs.items()) + ")",
               torch.bfloat16, BWD_BF16_TOL, max(errs.values()),
               max(max_abs(a, b) for a, b in zip(got, want)),
               time_ms(lambda: fused_ln_mlp_backward(*wbwd)),
               time_ms(lambda: _ln_mlp_backward_reference(*wbwd, 1e-5)),
               time_ms(wide_library_fwd_bwd),
               nbytes(x, lg_, lb_, w1, b1, w2, dy, *got), 10 * n_tok * wd * wh)
        repeat_equal(f"ln_mlp_bwd d {wd}",
                     lambda: fused_ln_mlp_backward(*wbwd), got)
        bwd_turns.append(in_turns(
            6, f"({n_tok},{wd}) hid {wh}",
            lambda: fused_ln_mlp_backward(*wbwd), wide_library_fwd_bwd,
            before, 10 * n_tok * wd * wh))
        del x, w1, w2, got, want, leaves

    # the fused GELU MLP (kernels 7 and 8) at ViT's shape: 64 images x 65
    # tokens, d 1024, hidden 2048, bf16 (the kernel path is bf16 only, as
    # JAX's gate); the library chain is F.linear -> F.gelu -> F.linear
    # (forward + backward for kernel 8)
    vn, vd, vh = 64 * 65, 1024, 2048
    x = randn(vn, vd, dtype=torch.bfloat16)
    w1 = randn(vh, vd, dtype=torch.bfloat16, scale=vd ** -0.5)
    b1 = randn(vh, scale=0.1)
    w2 = randn(vd, vh, dtype=torch.bfloat16, scale=vh ** -0.5)
    b2 = randn(vd, scale=0.1)
    margs = (x, w1, b1, w2, b2)
    got, want = fused_mlp(*margs), _fused_mlp_reference(*margs)
    b1b, b2b = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
    record("mlp", f"({vn},{vd}) hid {vh}", torch.bfloat16, BF16_TOL,
           rel_l2(got, want), max_abs(got, want),
           time_ms(lambda: fused_mlp(*margs)),
           time_ms(lambda: _fused_mlp_reference(*margs)),
           time_ms(lambda: F.linear(F.gelu(F.linear(x, w1, b1b)), w2, b2b)),
           nbytes(x, w1, b1, w2, b2, got), 4 * vn * vd * vh, main=True)
    dy = randn(vn, vd, dtype=torch.bfloat16)
    mbwd = (x, w1, b1, w2, dy)
    got = fused_mlp_backward(*mbwd)
    want = _fused_mlp_backward_reference(*mbwd)
    errs = {k: rel_l2(a, b) for k, a, b in zip(
        ("dx", "dw1", "db1", "dw2", "db2"), got, want)}
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, w1, b1b, w2, b2b)]

    def mlp_library_fwd_bwd():
        xl, w1l, b1l, w2l, b2l = leaves
        y = F.linear(F.gelu(F.linear(xl, w1l, b1l)), w2l, b2l)
        return torch.autograd.grad(y, leaves, dy)

    record("mlp_bwd", f"({vn},{vd}) hid {vh} (" + ", ".join(
               f"{k} {v:.2e}" for k, v in errs.items()) + ")",
           torch.bfloat16, BWD_BF16_TOL, max(errs.values()),
           max(max_abs(a, b) for a, b in zip(got, want)),
           time_ms(lambda: fused_mlp_backward(*mbwd)),
           time_ms(lambda: _fused_mlp_backward_reference(*mbwd)),
           time_ms(mlp_library_fwd_bwd), nbytes(x, w1, b1, w2, dy, *got),
           10 * vn * vd * vh, main=True)
    # kernel 8 on kernel 6's passes: no atomics, every sum in one order
    repeat_equal("mlp_bwd", lambda: fused_mlp_backward(*mbwd), got)
    bwd_turns.append(in_turns(
        8, f"({vn},{vd}) hid {vh}", lambda: fused_mlp_backward(*mbwd),
        mlp_library_fwd_bwd, 0.5694, 10 * vn * vd * vh))
    del x, w1, w2, got, want, leaves

    # kernels 7 and 2 at ragged rows (n 520 = 4 x 128 + 8: the last row
    # tile of each product is masked) and, for kernel 2, at the single
    # pass's old widths with the ViTVQGAN hidden width (1368 = 10 x 128 +
    # 88 columns, rows of g and W2 padded to 64 bytes)
    rn = 520
    for wd, wh in ((vd, vh), (128, hid), (256, hid), (384, hid)):
        x = randn(rn, wd, dtype=torch.bfloat16)
        w1 = randn(wh, wd, dtype=torch.bfloat16, scale=wd ** -0.5)
        b1, b2 = randn(wh, scale=0.1), randn(wd, scale=0.1)
        w2 = randn(wd, wh, dtype=torch.bfloat16, scale=wh ** -0.5)
        if wd == vd:
            rargs = (x, w1, b1, w2, b2)
            got, want = fused_mlp(*rargs), _fused_mlp_reference(*rargs)
            record("mlp", f"({rn},{wd}) hid {wh} ragged rows",
                   torch.bfloat16, BF16_TOL, rel_l2(got, want),
                   max_abs(got, want), time_ms(lambda: fused_mlp(*rargs)),
                   time_ms(lambda: _fused_mlp_reference(*rargs)),
                   time_ms(lambda: F.linear(F.gelu(F.linear(
                       x, w1, b1.bfloat16())), w2, b2.bfloat16())),
                   nbytes(x, w1, b1, w2, b2, got), 4 * rn * wd * wh)
            continue
        lg_, lb_ = randn(wd, scale=0.1, shift=1.0), randn(wd, scale=0.1)
        rargs = (x, lg_, lb_, w1, b1, w2, b2)
        got, want = fused_ln_mlp(*rargs), _ln_mlp_reference(*rargs, 1e-5)
        mlp_err = rel_l2(got.float() - x.float(), want.float() - x.float())
        lgb, lbb, b1b, b2b = (t.to(torch.bfloat16) for t in (lg_, lb_, b1, b2))
        record("ln_mlp", f"({rn},{wd}) hid {wh} ragged rows (MLP part "
               f"rel_l2 {mlp_err:.2e})", torch.bfloat16, BF16_TOL,
               rel_l2(got, want), max_abs(got, want),
               time_ms(lambda: fused_ln_mlp(*rargs)),
               time_ms(lambda: _ln_mlp_reference(*rargs, 1e-5)),
               time_ms(lambda: x + F.linear(F.gelu(F.linear(F.layer_norm(
                   x, (wd,), lgb, lbb), w1, b1b)), w2, b2b)),
               nbytes(x, x, lg_, lb_, w1, b1, w2, b2), 4 * rn * wd * wh)
        gate(mlp_err <= 2e-2, f"ln_mlp ({rn},{wd}) MLP part: {mlp_err}")
    del x, w1, w2, got, want, rargs

    # kernels 7 and 2 against their library chains in turns (kernel,
    # library, library, kernel; device time, launches queued behind a
    # sleep), then back to back, beside the mma.sync kernels they replace
    # (back to back, PERF.md's table: 0.1694 and 0.1761 ms, same card type)
    xm, wm1, bm1, wm2, bm2 = margs
    bm1b, bm2b = bm1.to(torch.bfloat16), bm2.to(torch.bfloat16)
    xl, lgl, lbl, wl1, bl1, wl2, bl2 = mlp_args
    lglb, lblb = lgl.to(torch.bfloat16), lbl.to(torch.bfloat16)
    mlp_turns = [in_turns(*t) for t in (
        (7, f"({vn},{vd}) hid {vh}", lambda: fused_mlp(*margs),
         lambda: F.linear(F.gelu(F.linear(xm, wm1, bm1b)), wm2, bm2b),
         0.1694, 4 * vn * vd * vh),
        (2, f"({n_tok},{dim}) hid {hid}", lambda: fused_ln_mlp(*mlp_args),
         lambda: xl + F.linear(F.gelu(F.linear(F.layer_norm(
             xl, (dim,), lglb, lblb), wl1, bl1)), wl2, bl2),
         0.1761, 4 * n_tok * dim * hid))]
    del xm, wm1, wm2, xl, wl1, wl2

    # the GEGLU FFN (kernels 11 and 12) at MaskGIT's decode shape (8 x 1024
    # rows, d 768, inner 4096), at ragged rows (n 520), at d 1024, and at
    # inner 8704 (n 520: a row wider than the 8192 columns the row passes
    # hold in registers, walked in chunks), bf16 and fp32 (TF32 off), each
    # with a bit-equal repeat call; the library
    # chain is F.linear -> chunk -> gelu * gate -> F.layer_norm -> F.linear
    # (for kernel 12 its forward + backward). At MaskGIT's shape both
    # kernels are read against their chains in turns, beside the times of
    # the kernels they replace (PERF.md's table: bf16 in turns, fp32 back to
    # back, same card type)
    ffn_before = {(11, torch.bfloat16): 0.7486, (12, torch.bfloat16): 2.3930,
                  (11, torch.float32): 6.3029, (12, torch.float32): 16.2629}
    for (fn_rows, fd, fi), dtype in itertools.product(
            ((n_tok, mg_dim, mg_inner), (520, mg_dim, mg_inner),
             (n_tok, 1024, mg_inner), (520, mg_dim, 8704)),
            (torch.bfloat16, torch.float32)):
        main_shape = (fn_rows, fd, fi) == (n_tok, mg_dim, mg_inner)
        dname = str(dtype).split(".")[-1]
        x = randn(fn_rows, fd, dtype=dtype)
        w1 = randn(2 * fi, fd, dtype=dtype, scale=fd ** -0.5)
        gam = randn(fi, scale=0.1, shift=1.0)
        w2 = randn(fd, fi, dtype=dtype, scale=fi ** -0.5)
        got, want = fused_ffn(x, w1, gam, w2), _ffn_reference(x, w1, gam, w2,
                                                             1e-5)
        gam_c = gam.to(dtype)

        def ffn_library():
            a, gate_ = F.linear(x, w1).chunk(2, dim=-1)
            y = F.layer_norm(gate_ * F.gelu(a), (fi,), gam_c)
            return F.linear(y, w2)

        shape = f"({fn_rows},{fd}) inner {fi}"
        record("ffn", shape, dtype,
               BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
               rel_l2(got, want), max_abs(got, want),
               time_ms(lambda: fused_ffn(x, w1, gam, w2)),
               time_ms(lambda: _ffn_reference(x, w1, gam, w2, 1e-5)),
               time_ms(ffn_library), nbytes(x, w1, gam, w2, got),
               6 * fn_rows * fd * fi,
               main=main_shape and dtype == torch.bfloat16)
        repeat_equal(f"ffn {shape} {dname}",
                     lambda: (fused_ffn(x, w1, gam, w2),), (got,))

        # its backward (kernel 12) on the same operands
        dy = randn(fn_rows, fd, dtype=dtype)
        got = fused_ffn_backward(x, w1, gam, w2, dy)
        want = _ffn_backward_reference(x, w1, gam, w2, dy, 1e-5)
        errs = {k: rel_l2(a, b) for k, a, b in zip(
            ("dx", "dw1", "dgamma", "dw2"), got, want)}
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, w1, gam_c, w2)]

        def ffn_library_fwd_bwd():
            xl, w1l, gl, w2l = leaves
            a, gate_ = F.linear(xl, w1l).chunk(2, dim=-1)
            y = F.linear(F.layer_norm(gate_ * F.gelu(a), (fi,), gl), w2l)
            return torch.autograd.grad(y, leaves, dy)

        record("ffn_bwd", f"{shape} (" + ", ".join(
                   f"{k} {v:.2e}" for k, v in errs.items()) + ")", dtype,
               BWD_BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
               max(errs.values()), max(max_abs(a, b) for a, b in zip(got, want)),
               time_ms(lambda: fused_ffn_backward(x, w1, gam, w2, dy)),
               time_ms(lambda: _ffn_backward_reference(x, w1, gam, w2, dy,
                                                       1e-5)),
               time_ms(ffn_library_fwd_bwd), nbytes(x, w1, gam, w2, dy, *got),
               16 * fn_rows * fd * fi,
               main=main_shape and dtype == torch.bfloat16)
        repeat_equal(f"ffn_bwd {shape} {dname}",
                     lambda: fused_ffn_backward(x, w1, gam, w2, dy), got)
        if main_shape:  # kernels 11 and 12 against their chains in turns
            bwd_turns.append(in_turns(
                11, shape, lambda: fused_ffn(x, w1, gam, w2), ffn_library,
                ffn_before[(11, dtype)], 6 * fn_rows * fd * fi, dname))
            bwd_turns.append(in_turns(
                12, shape, lambda: fused_ffn_backward(x, w1, gam, w2, dy),
                ffn_library_fwd_bwd, ffn_before[(12, dtype)],
                16 * fn_rows * fd * fi, dname))
        del x, w1, w2, dy, got, want, leaves

    # the GEGLU FFN forward at Muse's decode shape (16 x 1024 rows, d 1024,
    # inner 4096), bf16 (quant none), and in turns beside the time of the
    # kernel it replaces (1.8552 ms back to back, PERF.md's table)
    x = randn(16 * 1024, 1024, dtype=torch.bfloat16)
    w1 = randn(2 * 4096, 1024, dtype=torch.bfloat16, scale=1024 ** -0.5)
    gam = randn(4096, scale=0.1, shift=1.0)
    w2 = randn(1024, 4096, dtype=torch.bfloat16, scale=4096 ** -0.5)
    got, want = fused_ffn(x, w1, gam, w2), _ffn_reference(x, w1, gam, w2, 1e-5)
    gam_c = gam.to(torch.bfloat16)

    def ffn_library_muse():
        a, gate_ = F.linear(x, w1).chunk(2, dim=-1)
        return F.linear(F.layer_norm(gate_ * F.gelu(a), (4096,), gam_c), w2)

    record("ffn", "(16384,1024) inner 4096", torch.bfloat16, BF16_TOL,
           rel_l2(got, want), max_abs(got, want),
           time_ms(lambda: fused_ffn(x, w1, gam, w2)),
           time_ms(lambda: _ffn_reference(x, w1, gam, w2, 1e-5)),
           time_ms(ffn_library_muse), nbytes(x, w1, gam, w2, got),
           6 * 16 * 1024 * 1024 * 4096)
    repeat_equal("ffn (16384,1024) inner 4096 bfloat16",
                 lambda: (fused_ffn(x, w1, gam, w2),), (got,))
    bwd_turns.append(in_turns(
        11, "(16384,1024) inner 4096", lambda: fused_ffn(x, w1, gam, w2),
        ffn_library_muse, 1.8552, 6 * 16 * 1024 * 1024 * 4096))
    del x, w1, w2, got, want

    # the fused head cross-entropy (kernels 13 and 14) at MaskGIT's training
    # shape: 8 x 1024 rows, d 768, vocab 8192, ~36 % of the targets ignored
    # (-1), without and with Parti's bias, bf16 and fp32 (TF32 off); the
    # library is F.linear + F.cross_entropy(ignore_index=-1) (forward +
    # backward for kernel 14). Each kernel is bit-equal on a repeat call and
    # read against its chain in turns, beside the time it replaces (PERF.md's
    # table, same card type: kernel 13 back to back; kernel 14 bf16 back to
    # back, fp32 in turns)
    n_voc = 8192
    xent_before = {(13, torch.bfloat16, False): 0.4874,
                   (13, torch.bfloat16, True): 0.5516,
                   (13, torch.float32, False): 4.4199,
                   (13, torch.float32, True): None,
                   (14, torch.bfloat16, False): 1.4985,
                   (14, torch.bfloat16, True): 1.5293,
                   (14, torch.float32, False): 9.0345,
                   (14, torch.float32, True): None}
    for dtype, with_bias in ((torch.bfloat16, False), (torch.bfloat16, True),
                             (torch.float32, False), (torch.float32, True)):
        h = randn(n_tok, mg_dim, dtype=dtype)
        w = randn(n_voc, mg_dim, dtype=dtype, scale=mg_dim ** -0.5)
        bias = randn(n_voc, scale=0.1) if with_bias else None
        tgt = torch.randint(0, n_voc, (n_tok,), generator=gen, device=dev)
        tgt[torch.rand(n_tok, generator=gen, device=dev) < 0.36] = -1
        bias_c = bias.to(dtype) if with_bias else None
        label = f"({n_tok},{mg_dim}) V {n_voc} bias={with_bias}"
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        nll, lse = _head_xent_fwd_kernel(h, w, bias, tgt)
        nll_p, lse_p = _head_xent_reference(h, w, tgt, bias=bias)
        errs = {"nll": rel_l2(nll, nll_p), "lse": rel_l2(lse, lse_p)}
        extra = () if bias is None else (bias,)
        record("head_xent", f"{label} (nll {errs['nll']:.2e}, lse "
               f"{errs['lse']:.2e})", dtype, tol, max(errs.values()),
               max(max_abs(nll, nll_p), max_abs(lse, lse_p)),
               time_ms(lambda: _head_xent_fwd_kernel(h, w, bias, tgt)),
               time_ms(lambda: _head_xent_reference(h, w, tgt, bias=bias)),
               time_ms(lambda: F.cross_entropy(F.linear(h, w, bias_c), tgt,
                                               ignore_index=-1)),
               nbytes(h, w, tgt, nll, lse, *extra), 2 * n_tok * mg_dim * n_voc,
               main=dtype == torch.bfloat16 and not with_bias)
        valid = tgt != -1
        coef = valid.float() / valid.sum()
        got = head_xent_backward(h, w, tgt, lse_p, coef, bias=bias)
        want = _head_xent_backward_reference(h, w, tgt, lse_p, coef, bias)
        names = ("dh", "dw", "db")[:2 + with_bias]
        errs = {k: rel_l2(a, b) for k, a, b in zip(names, got, want)}
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (h, w, *(() if bias_c is None else (bias_c,)))]

        def xent_library_fwd_bwd():
            loss = F.cross_entropy(F.linear(*leaves), tgt, ignore_index=-1)
            return torch.autograd.grad(loss, leaves)

        record("head_xent_bwd", f"{label} (" + ", ".join(
                   f"{k} {v:.2e}" for k, v in errs.items()) + ")", dtype,
               BWD_BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
               max(errs.values()),
               max(max_abs(a, b) for a, b in zip(got, want) if b is not None),
               time_ms(lambda: head_xent_backward(h, w, tgt, lse_p, coef,
                                                  bias=bias)),
               time_ms(lambda: _head_xent_backward_reference(
                   h, w, tgt, lse_p, coef, bias)),
               time_ms(xent_library_fwd_bwd),
               nbytes(h, w, tgt, lse_p, coef, *extra,
                      *(t for t in got if t is not None)),
               6 * n_tok * mg_dim * n_voc,
               main=dtype == torch.bfloat16 and not with_bias)
        dname = str(dtype).split(".")[-1]
        repeat_equal(f"head_xent {dname} bias={with_bias}",
                     lambda: _head_xent_fwd_kernel(h, w, bias, tgt),
                     (nll, lse))
        repeat_equal(f"head_xent_bwd {dname} bias={with_bias}",
                     lambda: head_xent_backward(h, w, tgt, lse_p, coef,
                                                bias=bias), got)
        bwd_turns.append(in_turns(
            13, label, lambda: _head_xent_fwd_kernel(h, w, bias, tgt),
            lambda: F.cross_entropy(F.linear(h, w, bias_c), tgt,
                                    ignore_index=-1),
            xent_before[(13, dtype, with_bias)], 2 * n_tok * mg_dim * n_voc,
            dname))
        bwd_turns.append(in_turns(
            14, label, lambda: head_xent_backward(h, w, tgt, lse_p, coef,
                                                  bias=bias),
            xent_library_fwd_bwd, xent_before[(14, dtype, with_bias)],
            6 * n_tok * mg_dim * n_voc, dname))
        del got, want, leaves

    # the sampling epilogue at the decode shape: 8 x 1024 rows of 8192
    # logits, p 0.9 (k 820), step 0's temperature 17/18, CFG scale 3
    n_cls, p_keep, gs = 8192, 0.9, 3.0
    k_keep = math.ceil((1 - p_keep) * n_cls)
    temp0 = float(np.float32(17) / np.float32(18))
    inf = float("inf")

    def guided(cond, null):
        """The fp32 logits the epilogue samples from (its CFG combine)."""
        width = cond.shape[-1]
        x32 = cond.reshape(-1, width).float()
        if null is None:
            return x32
        n32 = null.reshape(-1, width).float()
        return n32 + torch.tensor(gs, dtype=torch.float32) * (x32 - n32)

    def epilogue_check(label, x32, bits, temp, got, want, gap_tol,
                       relative=True, x32_got=None, k=k_keep):
        """Picks equal wherever the plain noised top-2 gap (of the plain
        logits x32) exceeds gap_tol (times |top| if ``relative``), every
        pick in the kept set of the logits it was drawn from (``x32_got``,
        default x32), scores within relative 1e-5 where the picks agree.
        Returns (score rel err, its max abs err)."""
        pred, score = (t.reshape(-1) for t in got)
        pred_p, score_p = (t.reshape(-1) for t in want)
        kth = kth_value_bisect(x32, k)[:, None]
        noised = torch.where(x32 >= kth, x32 + torch.tensor(
            temp, dtype=torch.float32) * gumbel_of_bits(bits), -inf)
        top2 = noised.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        if relative:
            gap = gap / top2[:, 0].abs()
        differ = pred != pred_p
        worst = float(gap[differ].max()) if bool(differ.any()) else 0.0
        xg = x32 if x32_got is None else x32_got
        kept = bool((xg.gather(1, pred.long()[:, None])[:, 0]
                     >= kth_value_bisect(xg, k)).all())
        agree = ~differ
        err = float(((score - score_p).abs() / score_p)[agree].max())
        abs_err = float((score - score_p).abs()[agree].max())
        print(f"[kernel] sample_epilogue {label}: pick agreement "
              f"{float(agree.float().mean()):.6f}, largest "
              f"{'relative ' if relative else ''}top-2 gap "
              f"at a disagreement {worst:.3e} (tol {gap_tol:g}), picks kept "
              f"{kept}", flush=True)
        if not (worst <= gap_tol and kept):
            raise AssertionError(f"sample_epilogue {label}: pick criterion")
        return err, abs_err

    seeds8 = torch.arange(100, 108, device=dev)
    for dtype, with_null, philox in ((torch.bfloat16, False, False),
                                     (torch.bfloat16, True, False),
                                     (torch.float32, False, False),
                                     (torch.float32, True, False),
                                     (torch.bfloat16, False, True),
                                     (torch.float32, False, True)):
        cond = randn(8, 1024, n_cls, dtype=dtype, scale=3.0)
        null = randn(8, 1024, n_cls, dtype=dtype, scale=3.0) if with_null else None
        if philox:
            ext = None
            bits = philox_bits(seeds8, 1024, 5, n_cls)
        else:
            ext = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, 1024, n_cls),
                                generator=gen, device=dev, dtype=torch.int32)
            bits = ext.reshape(-1, n_cls)
        kw = dict(guidance_scale=gs, p=p_keep, temperature=temp0,
                  seeds=seeds8, step=5, noise_bits=ext)
        x32 = guided(cond, null)
        err, abs_err = epilogue_check(
            f"{dtype} null={with_null} bits={'philox' if philox else 'given'}",
            x32, bits, temp0, sample_epilogue_fused(cond, null, **kw),
            _sample_epilogue_reference(cond, null, **kw), 1e-5)
        g_k = gumbel_of_bits(bits[:, :k_keep])

        def sample_library():
            xl = cond if null is None else null + gs * (cond - null)
            vals, idx = torch.topk(xl.reshape(-1, n_cls), k_keep)
            choice = (vals.float() + temp0 * g_k).argmax(-1, keepdim=True)
            lse = torch.logsumexp(xl.reshape(-1, n_cls).float(), -1)
            return (idx.gather(-1, choice),
                    torch.exp(vals.gather(-1, choice)[:, 0].float() - lse))

        pred_out = torch.empty(8 * 1024, dtype=torch.int32, device=dev)
        score_out = torch.empty(8 * 1024, dtype=torch.float32, device=dev)
        record("sample_epilogue",
               f"({8 * 1024},{n_cls}) null={with_null} "
               f"bits={'philox' if philox else 'given'}", dtype, 1e-5, err,
               abs_err, time_ms(lambda: sample_epilogue_fused(cond, null, **kw)),
               time_ms(lambda: _sample_epilogue_reference(cond, null,
                                                          **kw)),
               time_ms(sample_library),
               nbytes(cond, *(t for t in (null, ext) if t is not None),
                      pred_out, score_out), 0,
               metric="score rel err (agreeing picks)",
               main=philox and dtype == torch.bfloat16)

    # the in-kernel Philox stream
    logits = randn(8, 1024, n_cls, dtype=torch.bfloat16, scale=3.0)
    x32 = logits.reshape(-1, n_cls).float()
    pred0, _ = sample_epilogue_fused(logits, temperature=0.0, seeds=seeds8)
    col = torch.arange(n_cls, device=dev)
    first_max = torch.where(x32 == x32.amax(-1, keepdim=True), col,
                            n_cls).amin(-1)
    greedy = bool((pred0.reshape(-1) == first_max).all())
    pred_b8, _ = sample_epilogue_fused(logits, temperature=1.0, seeds=seeds8,
                                       step=3)
    pred_b1, _ = sample_epilogue_fused(logits[5:6], temperature=1.0,
                                       seeds=seeds8[5:6], step=3)
    alone = bool(torch.equal(pred_b1[0], pred_b8[5]))
    pred_s4, _ = sample_epilogue_fused(logits, temperature=1.0, seeds=seeds8,
                                       step=4)
    step_moved = float((pred_s4 != pred_b8).float().mean())
    flat = torch.zeros(1, n_cls, n_cls, dtype=torch.bfloat16, device=dev)
    pred_u, _ = sample_epilogue_fused(flat, temperature=1.0,
                                      seeds=seeds8[:1], step=0)
    coverage = torch.unique(pred_u).numel() / n_cls
    print(f"[kernel] sample_epilogue Philox: temperature 0 = first argmax "
          f"{greedy}; row 5 alone = row 5 of 8 {alone}; step 4 vs 3 moves "
          f"{step_moved:.4f} of the picks; 8192 picks on constant logits "
          f"cover {coverage:.4f} of the classes (tol >= 0.60)", flush=True)
    if not (greedy and alone and step_moved > 0 and coverage >= 0.60):
        raise AssertionError("sample_epilogue Philox criteria failed")
    del cond, null, ext, bits, x32, logits, flat

    # rows wider than the 8192 values a block holds in registers (a 16384-
    # entry codebook, which JAX's gate takes): 1024 rows of 16384, bf16 and
    # fp32, Philox and given bits, against the plain version on the card
    wide_cls = 16384
    wide_k = math.ceil((1 - p_keep) * wide_cls)
    seeds1 = seeds8[:1]
    for dtype, philox in itertools.product((torch.bfloat16, torch.float32),
                                           (True, False)):
        cond = randn(1, 1024, wide_cls, dtype=dtype, scale=3.0)
        if philox:
            ext, bits = None, philox_bits(seeds1, 1024, 5, wide_cls)
        else:
            ext = torch.randint(-2 ** 31, 2 ** 31 - 1, (1, 1024, wide_cls),
                                generator=gen, device=dev, dtype=torch.int32)
            bits = ext.reshape(-1, wide_cls)
        kw = dict(p=p_keep, temperature=temp0, seeds=seeds1, step=5,
                  noise_bits=ext)
        label = (f"{dtype} C {wide_cls} bits="
                 f"{'philox' if philox else 'given'}")
        err, abs_err = epilogue_check(
            label, guided(cond, None), bits, temp0,
            sample_epilogue_fused(cond, **kw),
            _sample_epilogue_reference(cond, **kw), 1e-5, k=wide_k)
        g_k = gumbel_of_bits(bits[:, :wide_k])

        def wide_library():
            vals, idx = torch.topk(cond.reshape(-1, wide_cls), wide_k)
            choice = (vals.float() + temp0 * g_k).argmax(-1, keepdim=True)
            lse = torch.logsumexp(cond.reshape(-1, wide_cls).float(), -1)
            return (idx.gather(-1, choice),
                    torch.exp(vals.gather(-1, choice)[:, 0].float() - lse))

        record("sample_epilogue", f"(1024,{wide_cls}) null=False bits="
               f"{'philox' if philox else 'given'}", dtype, 1e-5, err,
               abs_err, time_ms(lambda: sample_epilogue_fused(cond, **kw)),
               time_ms(lambda: _sample_epilogue_reference(cond, **kw)),
               time_ms(wide_library),
               nbytes(cond, *(t for t in (ext,) if t is not None))
               + 8 * 1024, 0, metric="score rel err (agreeing picks)")
        del cond, ext, bits, g_k

    # the W8A8 blocks (kernels 19-21) at their main paths' shapes: Muse's FFN
    # (16 x 1024 rows of the CFG forward, d 1024, inner 4096) and the int8
    # tokenizer's LN + MLP (8 x 1024 rows, d 512, hid 1368), bf16 and fp32
    # (TF32 off), on weights quantized from fp32 as the models do; the
    # library chain quantizes with the plain helpers, multiplies with
    # torch._int_mm and takes the rest from F.linear / F.gelu /
    # F.layer_norm. Each against its plain version on the same inputs, with
    # the int8 activations that differ between the two
    mu_rows, mu_dim, mu_inner = 16 * 1024, 1024, 4096
    q8_ops = 6 * mu_rows * mu_dim * mu_inner

    def int_mm(a, qw):
        return torch._int_mm(a, qw.q.t()).float()

    def code_flips(got, want):
        return {k: int((got[k] != want[k]).sum()) for k in got}

    for dtype in (torch.bfloat16, torch.float32):
        x = randn(mu_rows, mu_dim, dtype=dtype)
        w1 = randn(2 * mu_inner, mu_dim, scale=mu_dim ** -0.5)
        gam = randn(mu_inner, scale=0.1, shift=1.0)
        w2 = randn(mu_dim, mu_inner, scale=mu_inner ** -0.5)
        q1, q2 = quantize_weight(w1), quantize_weight(w2)
        w1c = w1.to(dtype)
        tol = BF16_TOL if dtype == torch.bfloat16 else 1e-4
        weights = nbytes(q1.q, q1.scale, q2.q, q2.scale, gam)

        def ffn_q8_library():
            xq, sx = quantize_rows(x.float())
            a, gate_ = (int_mm(xq, q1) * sx * q1.scale).chunk(2, dim=-1)
            y = F.layer_norm(gate_ * F.gelu(a), (mu_inner,), gam)
            yq, sy = quantize_rows(y)
            return (int_mm(yq, q2) * sy * q2.scale).to(dtype)

        ck, cp = {}, {}
        got = fused_ffn_q8(x, q1, gam, q2, codes=ck)
        want = _ffn_q8_reference(x, q1, gam, q2, 1e-5, cp)
        flips = code_flips(ck, cp)
        record("ffn_q8", f"({mu_rows},{mu_dim}) inner {mu_inner} (int8 "
               f"codes differing: x {flips['xq']}, y {flips['yq']} of "
               f"{mu_rows * mu_inner})", dtype, tol, rel_l2(got, want),
               max_abs(got, want),
               time_ms(lambda: fused_ffn_q8(x, q1, gam, q2)),
               time_ms(lambda: _ffn_q8_reference(x, q1, gam, q2, 1e-5)),
               time_ms(ffn_q8_library), nbytes(x, got) + weights,
               [(q8_ops, "int8")], main=dtype == torch.bfloat16)
        # exact s32 sums and the plain version's order of every other step:
        # the same codes in both dtypes
        gate(flips["xq"] == 0 and flips["yq"] == 0,
             f"ffn_q8 {dtype}: int8 codes differ from the plain version's "
             f"({flips})")
        repeat_equal(f"ffn_q8 ({mu_rows},{mu_dim}) {str(dtype)[6:]}",
                     lambda: (fused_ffn_q8(x, q1, gam, q2),), (got,))

        def ffn_q8wide_library():
            a, gate_ = F.linear(x, w1c).float().chunk(2, dim=-1)
            y = F.layer_norm(gate_ * F.gelu(a), (mu_inner,), gam)
            yq, sy = quantize_rows(y)
            return (int_mm(yq, q2) * sy * q2.scale).to(dtype)

        ck, cp = {}, {}
        got = fused_ffn_q8wide(x, w1, gam, q2, codes=ck)
        want = _ffn_q8wide_reference(x, w1, gam, q2, 1e-5, cp)
        flips = code_flips(ck, cp)
        up = "bfloat16" if dtype == torch.bfloat16 else "float32"
        record("ffn_q8wide", f"({mu_rows},{mu_dim}) inner {mu_inner} (int8 "
               f"codes differing: y {flips['yq']} of {mu_rows * mu_inner})",
               dtype, tol, rel_l2(got, want), max_abs(got, want),
               time_ms(lambda: fused_ffn_q8wide(x, w1, gam, q2)),
               time_ms(lambda: _ffn_q8wide_reference(x, w1, gam, q2, 1e-5)),
               time_ms(ffn_q8wide_library),
               nbytes(x, got, w1c, gam, q2.q, q2.scale),
               [(q8_ops * 2 // 3, up), (q8_ops // 3, "int8")],
               main=dtype == torch.bfloat16)
        # fp32: the float64 sums rounded once give the plain version's
        # codes (the DMMA order against cuBLAS's DGEMM)
        if dtype == torch.float32:
            gate(flips["yq"] == 0, f"ffn_q8wide fp32: {flips['yq']} int8 "
                 f"codes differ from the plain version's")
        repeat_equal(f"ffn_q8wide ({mu_rows},{mu_dim}) {up}",
                     lambda: (fused_ffn_q8wide(x, w1, gam, q2),), (got,))
        bwd_turns.append(in_turns(
            20, f"({mu_rows},{mu_dim}) inner {mu_inner}",
            lambda: fused_ffn_q8wide(x, w1, gam, q2), ffn_q8wide_library,
            1.6280 if dtype == torch.bfloat16 else 20.3003,
            [(q8_ops * 2 // 3, up), (q8_ops // 3, "int8")], up))
        del x, w1, w1c, w2, q1, q2, got, want, ck, cp

    for dtype in (torch.bfloat16, torch.float32):
        x = randn(n_tok, dim, dtype=dtype)
        lng, lnb = randn(dim, scale=0.1, shift=1.0), randn(dim, scale=0.1)
        q1 = quantize_weight(randn(hid, dim, scale=dim ** -0.5))
        q2 = quantize_weight(randn(dim, hid, scale=hid ** -0.5))
        b1, b2 = randn(hid, scale=0.1), randn(dim, scale=0.1)
        args8 = (x, lng, lnb, q1, b1, q2, b2)
        tol = BF16_TOL if dtype == torch.bfloat16 else 1e-4

        def ln_mlp_q8_library():
            xq, sx = quantize_rows(F.layer_norm(x.float(), (dim,), lng, lnb))
            gq, sg = quantize_rows(F.gelu(int_mm(xq, q1) * sx * q1.scale + b1))
            return (x.float() + int_mm(gq, q2) * sg * q2.scale + b2).to(dtype)

        ck, cp = {}, {}
        got = fused_ln_mlp_q8(*args8, codes=ck)
        want = _ln_mlp_q8_reference(*args8, 1e-5, cp)
        flips = code_flips(ck, cp)
        # the MLP part alone, out - x, beside the residual sum
        mlp_err = rel_l2(got.float() - x.float(), want.float() - x.float())
        record("ln_mlp_q8", f"({n_tok},{dim}) hid {hid} (MLP part rel_l2 "
               f"{mlp_err:.2e}; int8 codes differing: y {flips['yq']} of "
               f"{n_tok * dim}, gelu {flips['gq']} of {n_tok * hid})", dtype,
               tol, rel_l2(got, want), max_abs(got, want),
               time_ms(lambda: fused_ln_mlp_q8(*args8)),
               time_ms(lambda: _ln_mlp_q8_reference(*args8, 1e-5)),
               time_ms(ln_mlp_q8_library),
               nbytes(x, got, lng, lnb, q1.q, q1.scale, b1, q2.q, q2.scale,
                      b2), [(4 * n_tok * dim * hid, "int8")],
               main=dtype == torch.bfloat16)
        gate(mlp_err <= 2 * tol, f"ln_mlp_q8 {dtype} MLP part: {mlp_err}")
        # float64 LayerNorm sums, exact s32 sums and the plain version's
        # order of every other step: the same codes in both dtypes
        gate(flips["yq"] == 0 and flips["gq"] == 0,
             f"ln_mlp_q8 {dtype}: int8 codes differ from the plain "
             f"version's ({flips})")
        repeat_equal(f"ln_mlp_q8 ({n_tok},{dim}) {str(dtype)[6:]}",
                     lambda: (fused_ln_mlp_q8(*args8),), (got,))
        bwd_turns.append(in_turns(
            21, f"({n_tok},{dim}) hid {hid}", lambda: fused_ln_mlp_q8(*args8),
            ln_mlp_q8_library,
            0.2099 if dtype == torch.bfloat16 else 0.2123,
            [(4 * n_tok * dim * hid, "int8")], str(dtype)[6:]))
        del x, q1, q2, got, want, args8

    # rows wider than the 4096 values a W8A8 row pass holds in registers
    # (walked in chunks): kernel 20 in both dtypes and kernel 19 at 520 rows,
    # d 768, inner 8704; kernel 21 at hid 8704; bf16 except kernel 20's fp32
    wn, wd, wi = 520, 768, 8704
    for kern, dtype in (("ffn_q8wide", torch.bfloat16),
                        ("ffn_q8wide", torch.float32),
                        ("ffn_q8", torch.bfloat16),
                        ("ln_mlp_q8", torch.bfloat16)):
        x = randn(wn, wd, dtype=dtype)
        tol = BF16_TOL if dtype == torch.bfloat16 else 1e-4
        ck, cp = {}, {}
        if kern == "ln_mlp_q8":
            lng, lnb = randn(wd, scale=0.1, shift=1.0), randn(wd, scale=0.1)
            q1 = quantize_weight(randn(wi, wd, scale=wd ** -0.5))
            q2 = quantize_weight(randn(wd, wi, scale=wi ** -0.5))
            b1, b2 = randn(wi, scale=0.1), randn(wd, scale=0.1)
            wargs = (x, lng, lnb, q1, b1, q2, b2)
            run, ref = fused_ln_mlp_q8, _ln_mlp_q8_reference
            ops = [(4 * wn * wd * wi, "int8")]
        else:
            gam = randn(wi, scale=0.1, shift=1.0)
            w1 = randn(2 * wi, wd, scale=wd ** -0.5)
            q2 = quantize_weight(randn(wd, wi, scale=wi ** -0.5))
            if kern == "ffn_q8":
                wargs = (x, quantize_weight(w1), gam, q2)
                run, ref = fused_ffn_q8, _ffn_q8_reference
                ops = [(6 * wn * wd * wi, "int8")]
            else:
                wargs = (x, w1, gam, q2)
                run, ref = fused_ffn_q8wide, _ffn_q8wide_reference
                ops = [(4 * wn * wd * wi, str(dtype).split(".")[-1]),
                       (2 * wn * wd * wi, "int8")]
        got, want = run(*wargs, codes=ck), ref(*wargs, 1e-5, cp)
        flips = code_flips(ck, cp)
        record(kern, f"({wn},{wd}) inner {wi}, rows past 4096 (int8 codes "
               f"differing: " + ", ".join(f"{k} {v}" for k, v in flips.items())
               + ")", dtype, tol, rel_l2(got, want), max_abs(got, want),
               time_ms(lambda: run(*wargs)),
               time_ms(lambda: ref(*wargs, 1e-5)), None,
               nbytes(x, got), ops)
        if kern in ("ffn_q8wide", "ln_mlp_q8"):
            repeat_equal(f"{kern} ({wn},{wd}) inner {wi} "
                         f"{str(dtype)[6:]}", lambda: (run(*wargs),), (got,))
        if kern == "ln_mlp_q8":
            gate(all(v == 0 for v in flips.values()),
                 f"ln_mlp_q8 hid {wi}: {flips}")
        if dtype == torch.float32:
            gate(flips["yq"] == 0, f"{kern} fp32 inner {wi}: {flips}")
        del x, wargs, got, want, ck, cp

    # the shapes this slice's paths give the kernels, each against its plain
    # version: kernel 4 at the CNN tokenizer's z (8 images x 256 tokens of
    # width 256) against its 1024 codes (width 256 takes the first design),
    # both dtypes under the index criterion, bit-equal on a repeat call and
    # in turns against addmm + argmin (TF32 off)
    for dtype in (torch.bfloat16, torch.float32):
        z = l2_normalize(randn(2048, 256)).to(dtype)
        codes = l2_normalize(randn(1024, 256)).to(dtype)
        idx, idx_p = nearest_codes(z, codes), _nearest_codes_reference(z, codes)
        agree, worst_gap, excess = index_report(idx, idx_p,
                                                plain_distances(z, codes))
        gate(worst_gap <= 1e-5 and excess <= 1e-5,
             f"nearest_codes (2048,256) x 1024 {dtype}: largest gap at a "
             f"disagreement {worst_gap}, chosen-distance excess {excess}")
        zf, cf = z.float(), codes.float()

        def codes_addmm():
            return torch.addmm(torch.sum(cf * cf, dim=-1), zf, cf.T,
                               alpha=-2).argmin(dim=1)

        record("nearest_codes", f"z (2048,256) codes (1024,256) (index "
               f"agreement {agree:.6f})", dtype, 1e-5, excess, excess,
               time_ms(lambda: nearest_codes(z, codes)),
               time_ms(lambda: _nearest_codes_reference(z, codes)),
               time_ms(codes_addmm), nbytes(z, codes, idx),
               2 * 2048 * 1024 * 256, metric="chosen-distance excess")
        repeat_equal(f"nearest_codes (2048,256) x 1024 {str(dtype)[6:]}",
                     lambda: [nearest_codes(z, codes)], [idx])
        codes_turns.append(in_turns(
            4, "z (2048,256) codes (1024,256) against addmm+argmin",
            lambda: nearest_codes(z, codes), codes_addmm, None,
            2 * 2048 * 1024 * 256, peak=str(dtype)[6:]))
    del z, codes, zf, cf

    # kernel 3 at the Transformer's rows (64 x 20 encoder, 64 x 21 decoder
    # tokens): its gamma LayerNorms at d 512 and its FFN's inner norm at d
    # 1365 (an odd width: the unaligned scalar path, a block a row), bf16
    # and fp32, bit-equal on a repeat call, in turns against F.layer_norm
    for rows, d, dtype in itertools.product(
            (1280, 1344), (512, 1365), (torch.bfloat16, torch.float32)):
        x = randn(rows, d, dtype=dtype, scale=2.0, shift=0.5)
        g = randn(d, scale=0.1, shift=1.0)
        got, want = layernorm(x, g), _ln_reference(x, g, None, 1e-5)
        gl = g.to(dtype)
        ln_label = f"({rows},{d}) no beta"
        record("layernorm", ln_label, dtype,
               BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
               rel_l2(got, want), max_abs(got, want),
               time_ms(lambda: layernorm(x, g)),
               time_ms(lambda: _ln_reference(x, g, None, 1e-5)),
               time_ms(lambda: F.layer_norm(x, (d,), gl)),
               nbytes(x, x, g), 8 * x.numel())
        repeat_equal(f"layernorm {ln_label} {str(dtype)[6:]}",
                     lambda: (layernorm(x, g),), (got,))
        ln_turns.append(in_turns(
            3, ln_label, lambda: layernorm(x, g),
            lambda: F.layer_norm(x, (d,), gl), None, 8 * x.numel(),
            str(dtype).split(".")[-1], bytes_moved=nbytes(x, x, g)))
    del x, got, want

    # kernels 1 and 5 at Muse's 256 tokens (the CNN tokenizer's grid), h 16:
    # the forward at the 16-row CFG batch, the backward at the training
    # batch of 8, both dtypes (both pass the flash gate at t 256), against
    # the plain versions and SDPA, bit-equal on a repeat call
    scale = d_ ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        q = randn(16, 256, 16, d_, dtype=dtype)
        kv = randn(16, 256, 2, 16, d_, dtype=dtype)
        out, lse = flash_attention_bthd_kv(q, kv)
        out_p, lse_p = _flash_reference(q, kv, scale, False)
        lse_err = rel_l2(lse, lse_p)
        gate(lse_err <= tol, f"flash t256 h16 lse rel_l2 {lse_err}")
        qs = q.transpose(1, 2).contiguous()
        ks = kv[:, :, 0].transpose(1, 2).contiguous()
        vs = kv[:, :, 1].transpose(1, 2).contiguous()
        record("flash_attention_bthd_kv", f"b16 t256 h16 d{d_} (lse rel_l2 "
               f"{lse_err:.2e})", dtype, tol, rel_l2(out, out_p),
               max_abs(out, out_p),
               time_ms(lambda: flash_attention_bthd_kv(q, kv)),
               time_ms(lambda: _flash_reference(q, kv, scale, False)),
               time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
               nbytes(q, kv, out, lse), 4 * 16 * 16 * d_ * 256 * 256)
        repeat_equal(f"flash_attention_bthd_kv b16 t256 h16 "
                     f"{str(dtype)[6:]}",
                     lambda: flash_attention_bthd_kv(q, kv), (out, lse))
        q, kv = q[:8].contiguous(), kv[:8].contiguous()
        out, lse = flash_attention_bthd_kv(q, kv)
        g = randn(8, 256, 16, d_, dtype=dtype)
        got = flash_attention_bwd_kv(q, kv, out, lse, g, scale=scale)
        want = _flash_backward_reference(q, kv, out, lse, g, scale, False)
        pairs = [(got[0], want[0]), (got[1][:, :, 0], want[1][:, :, 0]),
                 (got[1][:, :, 1], want[1][:, :, 1])]
        errs = [rel_l2(a, b) for a, b in pairs]
        qs, ks, vs = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, kv[:, :, 0], kv[:, :, 1]))
        gs_ = g.transpose(1, 2).contiguous()

        def sdpa_t256_fwd_bwd():
            o = F.scaled_dot_product_attention(qs, ks, vs)
            return torch.autograd.grad(o, (qs, ks, vs), gs_)

        record("flash_attention_bwd_kv", f"b8 t256 h16 d{d_} (dq, dk, dv "
               f"rel_l2 {errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e})", dtype,
               BWD_BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
               max(errs), max(max_abs(a, b) for a, b in pairs),
               time_ms(lambda: flash_attention_bwd_kv(q, kv, out, lse, g,
                                                      scale=scale)),
               time_ms(lambda: _flash_backward_reference(q, kv, out, lse, g,
                                                         scale, False)),
               time_ms(sdpa_t256_fwd_bwd), nbytes(q, kv, out, lse, g, *got),
               10 * 8 * 16 * d_ * 256 * 256)
        repeat_equal(f"flash_attention_bwd_kv b8 t256 h16 {str(dtype)[6:]}",
                     lambda: flash_attention_bwd_kv(q, kv, out, lse, g,
                                                    scale=scale), got)
    del q, kv, out, lse, g, got, want, qs, ks, vs

    # kernels 13 and 14 at Muse's training head over the CNN tokenizer's
    # codebook: 8 x 256 rows, d 1024, vocab 1024, no bias, ~36 % of the
    # targets ignored, bf16 and fp32, bit-equal on a repeat call
    for dtype in (torch.bfloat16, torch.float32):
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        h = randn(2048, 1024, dtype=dtype)
        w = randn(1024, 1024, dtype=dtype, scale=1024 ** -0.5)
        tgt = torch.randint(0, 1024, (2048,), generator=gen, device=dev)
        tgt[torch.rand(2048, generator=gen, device=dev) < 0.36] = -1
        nll, lse = _head_xent_fwd_kernel(h, w, None, tgt)
        nll_p, lse_p = _head_xent_reference(h, w, tgt)
        errs = {"nll": rel_l2(nll, nll_p), "lse": rel_l2(lse, lse_p)}
        record("head_xent", f"(2048,1024) V 1024 (nll {errs['nll']:.2e}, "
               f"lse {errs['lse']:.2e})", dtype, tol, max(errs.values()),
               max(max_abs(nll, nll_p), max_abs(lse, lse_p)),
               time_ms(lambda: _head_xent_fwd_kernel(h, w, None, tgt)),
               time_ms(lambda: _head_xent_reference(h, w, tgt)),
               time_ms(lambda: F.cross_entropy(F.linear(h, w), tgt,
                                               ignore_index=-1)),
               nbytes(h, w, tgt, nll, lse), 2 * 2048 * 1024 * 1024)
        repeat_equal(f"head_xent V 1024 {str(dtype)[6:]}",
                     lambda: _head_xent_fwd_kernel(h, w, None, tgt),
                     (nll, lse))
        valid = tgt != -1
        coef = valid.float() / valid.sum()
        got = head_xent_backward(h, w, tgt, lse_p, coef)
        want = _head_xent_backward_reference(h, w, tgt, lse_p, coef, None)
        errs = {k: rel_l2(a, b) for k, a, b in zip(("dh", "dw"), got, want)}
        leaves = [t.detach().clone().requires_grad_(True) for t in (h, w)]

        def xent_v1024_fwd_bwd():
            loss = F.cross_entropy(F.linear(*leaves), tgt, ignore_index=-1)
            return torch.autograd.grad(loss, leaves)

        record("head_xent_bwd", "(2048,1024) V 1024 (" + ", ".join(
                   f"{k} {v:.2e}" for k, v in errs.items()) + ")", dtype,
               BWD_BF16_TOL if dtype == torch.bfloat16 else F32_TOL,
               max(errs.values()),
               max(max_abs(a, b) for a, b in zip(got, want) if b is not None),
               time_ms(lambda: head_xent_backward(h, w, tgt, lse_p, coef)),
               time_ms(lambda: _head_xent_backward_reference(
                   h, w, tgt, lse_p, coef, None)),
               time_ms(xent_v1024_fwd_bwd),
               nbytes(h, w, tgt, lse_p, coef,
                      *(t for t in got if t is not None)),
               6 * 2048 * 1024 * 1024)
        repeat_equal(f"head_xent_bwd V 1024 {str(dtype)[6:]}",
                     lambda: head_xent_backward(h, w, tgt, lse_p, coef), got)
    del h, w, tgt, nll, lse, got, want, leaves

    # kernel 15 at Muse's decode step over the CNN tokenizer: 8 x 256 rows
    # of 1024 classes (k 103), CFG, bf16 on Philox bits (the service's
    # approx path) and fp32 on given bits
    k_1024 = math.ceil((1 - p_keep) * 1024)
    for dtype, philox in ((torch.bfloat16, True), (torch.float32, False)):
        cond = randn(8, 256, 1024, dtype=dtype, scale=3.0)
        null = randn(8, 256, 1024, dtype=dtype, scale=3.0)
        if philox:
            ext, bits = None, philox_bits(seeds8, 256, 5, 1024)
        else:
            ext = torch.randint(-2 ** 31, 2 ** 31 - 1, (8, 256, 1024),
                                generator=gen, device=dev, dtype=torch.int32)
            bits = ext.reshape(-1, 1024)
        kw = dict(guidance_scale=gs, p=p_keep, temperature=temp0,
                  seeds=seeds8, step=5, noise_bits=ext)
        label = (f"{dtype} C 1024 null=True bits="
                 f"{'philox' if philox else 'given'}")
        err, abs_err = epilogue_check(
            label, guided(cond, null), bits, temp0,
            sample_epilogue_fused(cond, null, **kw),
            _sample_epilogue_reference(cond, null, **kw), 1e-5, k=k_1024)
        g_k = gumbel_of_bits(bits[:, :k_1024])

        def sample_1024_library():
            xl = (null + gs * (cond - null)).reshape(-1, 1024)
            vals, idx = torch.topk(xl, k_1024)
            choice = (vals.float() + temp0 * g_k).argmax(-1, keepdim=True)
            lse = torch.logsumexp(xl.float(), -1)
            return (idx.gather(-1, choice),
                    torch.exp(vals.gather(-1, choice)[:, 0].float() - lse))

        record("sample_epilogue", f"(2048,1024) null=True bits="
               f"{'philox' if philox else 'given'}", dtype, 1e-5, err,
               abs_err,
               time_ms(lambda: sample_epilogue_fused(cond, null, **kw)),
               time_ms(lambda: _sample_epilogue_reference(cond, null, **kw)),
               time_ms(sample_1024_library),
               nbytes(cond, null, *(t for t in (ext,) if t is not None))
               + 8 * 2048, 0, metric="score rel err (agreeing picks)")
    del cond, null, ext, bits, g_k

    # ---------------------------------------------------------- 4 and 5 --
    wrappers = {"flash_attention_bthd_kv": flash_attention_bthd_kv,
                "ln_mlp": fused_ln_mlp, "layernorm": layernorm,
                "nearest_codes": nearest_codes,
                "flash_attention_bwd_kv": flash_attention_bwd_kv,
                "ln_mlp_bwd": fused_ln_mlp_backward, "ffn": fused_ffn,
                "sample_epilogue": sample_epilogue_fused,
                "ffn_bwd": fused_ffn_backward, "head_xent": fused_head_xent,
                "head_xent_bwd": head_xent_backward, "ffn_q8": fused_ffn_q8,
                "ffn_q8wide": fused_ffn_q8wide, "ln_mlp_q8": fused_ln_mlp_q8,
                "mlp": fused_mlp, "mlp_bwd": fused_mlp_backward,
                "flash_attention_bthd": flash_attention_bthd,
                "flash_attention_bwd_bthd": flash_attention_bwd_bthd,
                "flash_forward": flash_forward,
                "flash_bwd_dkv": flash_bwd_dkv, "flash_bwd_dq": flash_bwd_dq}
    per_forward = {"flash_attention_bthd_kv": 12, "ln_mlp": 12,
                   "layernorm": 16, "nearest_codes": 1}
    per_encode = {"flash_attention_bthd_kv": 6, "ln_mlp": 6,
                  "layernorm": 9, "nearest_codes": 1}

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0
        return counts()

    def expect_delta(before, want, what):
        """Every kernel's launches since ``before`` equal ``want`` (0 for a
        kernel it does not name)."""
        now = counts()
        delta = {k: now[k] - before[k] for k in now}
        want = {k: want.get(k, 0) for k in now}
        if delta != want:
            raise AssertionError(f"{what}: launches {delta}, expected {want}")
        return now

    def traced(step_fn, rows, scalars):
        """``step_fn`` that also appends to ``rows`` its ms (the card
        synchronised before and after), the named scalars of the dict it
        returns and the kernels it launched."""
        def step(*args, **kw):
            torch.cuda.synchronize()
            before = counts()
            t = time.perf_counter()
            m = step_fn(*args, **kw)
            torch.cuda.synchronize()
            rows.append(dict(ms=(time.perf_counter() - t) * 1e3,
                             launches={k: v - before[k]
                                       for k, v in counts().items()},
                             **{k: float(m[k]) for k in scalars}))
            return m
        return step

    # one full-width block, forward + backward, kernels against plain
    torch.manual_seed(0)
    blk = ViTVQGANBlock(dim, h_, d_, 2048).to(dev)
    xb = randn(8, 1024, dim, dtype=torch.bfloat16)
    gb = randn(8, 1024, dim, dtype=torch.bfloat16)
    blk_names = ["dx"] + [k for k, _ in blk.named_parameters()]

    def block_grads(kernels):
        for m in blk.modules():
            if hasattr(m, "kernels"):
                m.kernels = kernels
        xr = xb.clone().requires_grad_(True)
        return torch.autograd.grad(blk(xr), [xr, *blk.parameters()], gb)

    c = counts()
    grads_k = block_grads(True)
    expect_delta(c, {k: 1 for k in ("flash_attention_bthd_kv", "ln_mlp",
                                     "layernorm", "flash_attention_bwd_kv",
                                     "ln_mlp_bwd")},
                 "block forward + backward")
    grads_p = block_grads(False)
    blk_errs = {k: rel_l2(a, b) for k, a, b in zip(blk_names, grads_k,
                                                   grads_p)}
    worst = max(blk_errs, key=blk_errs.get)
    print(f"[block] ViTVQGANBlock b8 t1024 d{dim}, bf16 over fp32 params, "
          f"fwd+bwd kernels vs plain: dx rel_l2 {blk_errs['dx']:.3e}, worst "
          f"{worst} {blk_errs[worst]:.3e} (tol {MODEL_BF16_TOL:g}), "
          f"{len(blk_errs)} gradients", flush=True)
    if not all(e <= MODEL_BF16_TOL for e in blk_errs.values()):
        raise AssertionError(f"block gradients: {blk_errs}")
    del blk, grads_k, grads_p

    # one full-width MaskGIT EncoderLayer, final_norm and the head loss, b 8,
    # t 1024, d 768, bf16 compute over fp32 parameters, dropout 0.1 drawn
    # from the same generator seed on both paths (so the masks are equal),
    # ~36 % of the targets ignored: kernels against plain on dx and every
    # parameter gradient
    init = torch.Generator().manual_seed(1)
    mlayer = EncoderLayer(mg_dim, mg_heads, 64, 8, dropout=0.1)
    for m in mlayer.modules():
        if isinstance(m, torch.nn.Linear):
            lecun_normal_(m.weight, init)
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)
    mlayer, fnorm = mlayer.to(dev), GammaLayerNorm(mg_dim).to(dev)
    head_w = torch.nn.init.trunc_normal_(
        torch.empty(8192, mg_dim), 0.0, 0.02, -0.04, 0.04,
        generator=init).to(dev).requires_grad_(True)
    xl = randn(8, 1024, mg_dim, dtype=torch.bfloat16)
    tgt_l = torch.randint(0, 8192, (8, 1024), generator=gen, device=dev)
    tgt_l[torch.rand(8, 1024, generator=gen, device=dev) < 0.36] = -1
    lparams = [*mlayer.parameters(), *fnorm.parameters(), head_w]
    lnames = (["dx"] + [f"layer.{k}" for k, _ in mlayer.named_parameters()]
              + [f"final_norm.{k}" for k, _ in fnorm.named_parameters()]
              + ["head"])

    def layer_grads(kernels):
        for m in (*mlayer.modules(), fnorm):
            if hasattr(m, "kernels"):
                m.kernels = kernels
        xr = xl.clone().requires_grad_(True)
        drop = torch.Generator(device=dev).manual_seed(5)
        hf = fnorm(mlayer(xr, deterministic=False, generator=drop))
        loss = (fused_head_xent if kernels else _head_xent_loss_reference)(
            hf, head_w, tgt_l)
        return torch.autograd.grad(loss, [xr, *lparams])

    c = counts()
    lgrads_k = layer_grads(True)
    expect_delta(c, {"flash_attention_bthd_kv": 1, "layernorm": 3, "ffn": 1,
                     "flash_attention_bwd_kv": 1, "ffn_bwd": 1,
                     "head_xent": 1, "head_xent_bwd": 1},
                 "MaskGIT layer + head forward + backward")
    lgrads_p = layer_grads(False)
    mlayer_errs = {k: rel_l2(a, b) for k, a, b in zip(lnames, lgrads_k,
                                                      lgrads_p)}
    worst = max(mlayer_errs, key=mlayer_errs.get)
    print(f"[block] MaskGIT EncoderLayer + final_norm + head loss b8 t1024 "
          f"d{mg_dim}, bf16 over fp32 params, dropout 0.1: fwd+bwd kernels "
          f"vs plain: dx rel_l2 {mlayer_errs['dx']:.3e}, head "
          f"{mlayer_errs['head']:.3e}, worst {worst} {mlayer_errs[worst]:.3e}"
          f" (tol {MODEL_BF16_TOL:g}), {len(mlayer_errs)} gradients",
          flush=True)
    if not all(e <= MODEL_BF16_TOL for e in mlayer_errs.values()):
        raise AssertionError(f"MaskGIT layer gradients: {mlayer_errs}")
    del mlayer, fnorm, head_w, lgrads_k, lgrads_p, lparams

    fn, (model, imgs0) = entry()
    rs = np.random.RandomState(0)
    requests = [rs.rand(8, 3, 256, 256).astype(np.float32) for _ in range(3)]
    recon, encode = vq_recon_service(model), vq_encode_service(model)

    torch.cuda.synchronize()
    c = zero_counts()
    rec0, loss0 = fn(model, imgs0)
    c = expect_delta(c, per_forward, "entry forward")
    recs = []
    for r in requests:
        recs.append(recon(r, None))
        c = expect_delta(c, per_forward, "recon request")
    idx_main = encode(requests[0], None)
    c = expect_delta(c, per_encode, "encode request")
    torch.cuda.synchronize()
    serving_launches = counts()
    print(f"[main] launches over 1 entry forward + 3 recon + 1 encode "
          f"request(s): {serving_launches}", flush=True)
    for t in (rec0, loss0, *recs):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite output on the main path")
    if recs[0].shape != (8, 3, 256, 256) or idx_main.shape != (8, 1024):
        raise AssertionError(f"shapes {recs[0].shape}, {idx_main.shape}")

    # the same weights through the plain path on the card
    with torch.inference_mode():
        x0 = torch.as_tensor(requests[0], device=dev)
        z_k = model.pre_quant(model.encoder(x0))
        dec_k = model.decode_indices(idx_main)
        model.use_kernels(False)
        z_p = model.pre_quant(model.encoder(x0))
        dec_p = model.decode_indices(idx_main)
        rec_p = recon(requests[0], None)
        idx_p = encode(requests[0], None)
        model.use_kernels(True)
    z_err, dec_err = rel_l2(z_k, z_p), rel_l2(dec_k, dec_p)
    print(f"[main] kernel vs plain on the card (bf16): encoder z rel_l2 "
          f"{z_err:.3e}, decoder on identical indices rel_l2 {dec_err:.3e} "
          f"(tol {MODEL_BF16_TOL:g}); index agreement "
          f"{float((idx_main == idx_p).float().mean()):.4f}, whole recon "
          f"rel_l2 {rel_l2(recs[0], rec_p):.3e} (reported)", flush=True)
    if not (z_err <= MODEL_BF16_TOL and dec_err <= MODEL_BF16_TOL):
        raise AssertionError("bf16 model kernel path disagrees with plain")

    def imgs_per_s(svc=recon, iters=10):
        svc(requests[0], None)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(iters):
            svc(requests[i % 3], None)
        torch.cuda.synchronize()
        return 8 * iters / (time.perf_counter() - t)

    kern_ips = imgs_per_s()
    model.use_kernels(False)
    plain_ips = imgs_per_s()
    model.use_kernels(True)
    print(f"[main] recon throughput, batch 8, 256 px, bf16: kernels "
          f"{kern_ips:.2f} imgs/s, plain {plain_ips:.2f} imgs/s | {smi}",
          flush=True)

    # the wrappers launch the forward kernel directly when nothing needs a
    # gradient (dispatch.needs_grad); against their autograd Functions on
    # the same requests, 10 alternating pairs (ABBA order) in this process
    def function_always(on):
        for m in (ffn_mod, flash_mod, ln_mod):
            m.needs_grad = (lambda *t: True) if on else dispatch.needs_grad

    wrapper_ab = {"direct": [], "function": []}
    for i in range(10):
        for way in (("direct", "function"), ("function", "direct"))[i % 2]:
            function_always(way == "function")
            wrapper_ab[way].append(imgs_per_s())
    function_always(False)
    ab_med = {k: float(np.median(v)) for k, v in wrapper_ab.items()}
    ab_won = sum(a > b for a, b in zip(wrapper_ab["direct"],
                                       wrapper_ab["function"]))
    print(f"[main] recon imgs/s, direct launch vs autograd Function, 10 "
          f"pairs: median {ab_med['direct']:.2f} vs {ab_med['function']:.2f}"
          f" (direct {min(wrapper_ab['direct']):.2f}-"
          f"{max(wrapper_ab['direct']):.2f}, Function "
          f"{min(wrapper_ab['function']):.2f}-"
          f"{max(wrapper_ab['function']):.2f}); direct faster in {ab_won} of"
          f" 10 pairs", flush=True)
    profile_rows = profile(torch, lambda: [recon(r, None) for r in requests],
                           lambda: recon(requests[0], None),
                           "3 recon requests")
    # the ln_mlp products (csrc/gemm_sm90.cuh's gemm_kernel: only ln_mlp
    # launches it on this path) a request; its 12 LayerNorm passes share
    # the layernorm kernel's rows with the blocks' other LayerNorms
    ln_mlp_ms = sum(r["ms"] for r in profile_rows["rows"]
                    if "gemm_kernel" in r["key"]) / len(requests)
    ln_ms = sum(r["ms"] for r in profile_rows["rows"]
                if "layernorm" in r["key"]) / len(requests)
    profile_rows["ln_mlp_products_ms_per_request"] = ln_mlp_ms
    print(f"[profile] ln_mlp products {ln_mlp_ms:.3f} ms of device time a "
          f"recon request ({per_forward['ln_mlp']} calls, 2 launches each); "
          f"every LayerNorm kernel of the request, the ln_mlp passes "
          f"among them, {ln_ms:.3f} ms", flush=True)

    # ---------------------------------------------------------------- 6 --
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the fp32 golden path")
    model32 = vitvqgan_base(img_size=256, dtype=torch.float32, device=dev)
    x32 = torch.as_tensor(requests[1], device=dev)
    golden_want = {"flash_attention_bthd_kv": 6, "layernorm": 15,
                   "nearest_codes": 1}
    with torch.inference_mode():
        c = counts()
        idx_k = model32.encode_imgs(x32).reshape(-1)
        expect_delta(c, golden_want, "fp32 encode")
        model32.use_kernels(False)
        z_p = model32.pre_quant(model32.encoder(x32))
        idx_p = model32.codebook.nearest(z_p).reshape(-1)
        table = l2_normalize(model32.codebook.embedding.weight.float())
        dist = plain_distances(l2_normalize(z_p.float()).reshape(-1, 32),
                               table)
    agree, worst_gap, _ = index_report(idx_k, idx_p, dist)
    print(f"[golden] fp32 encode_imgs, TF32 off: index agreement {agree:.6f}"
          f" (tol >= 0.999), largest plain top-2 gap at a disagreement "
          f"{worst_gap:.3e} (tol 1e-4)", flush=True)
    if not (agree >= 0.999 and worst_gap <= 1e-4):
        raise AssertionError("fp32 golden index criterion failed")
    del model, model32

    # ---------------------------------------------------------------- 7 --
    # the training path, as `python -m attention_models_torch.main` runs
    # it (PyTorch's TF32 defaults: cuDNN convolutions in TF32)
    torch.backends.cudnn.allow_tf32 = True
    cfg = training_config(os.path.abspath(os.path.join(
        "chiprun_out", "chip_smoke_train")))
    trainer = build_trainer(cfg, build_model(cfg), build_loader(cfg), dev)
    step_fn = trainer.train_step
    steps = []

    def traced_step(img):
        torch.cuda.synchronize()
        before = counts()
        g0 = [p.detach().clone() for p in trainer.g_params]
        d0 = [p.detach().clone() for p in trainer.d_params]
        t = time.perf_counter()
        m = step_fn(img)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        steps.append(dict(
            ms=ms, losses={k: float(v) for k, v in m.items()},
            launches={k: v - before[k] for k, v in counts().items()},
            g_changed=any(not torch.equal(a, p)
                          for a, p in zip(g0, trainer.g_params)),
            d_changed=any(not torch.equal(a, p)
                          for a, p in zip(d0, trainer.d_params))))
        return m

    trainer.train_step = traced_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    trainer.train()
    torch.cuda.synchronize()
    launches = counts()
    trainer.train_step = step_fn
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    k_acc = trainer.gradient_accumulation_steps
    for i, st in enumerate(steps):
        print(f"[train] micro-step {i}: {st['ms']:.2f} ms, G changed "
              f"{st['g_changed']}, D changed {st['d_changed']}, losses "
              + ", ".join(f"{k} {v:.4f}" for k, v in st["losses"].items()),
              flush=True)
        if st["launches"] != {k: PER_MICRO_STEP.get(k, 0)
                              for k in st["launches"]}:
            raise AssertionError(f"micro-step {i}: launches "
                                 f"{st['launches']}, expected "
                                 f"{PER_MICRO_STEP}")
        if not all(np.isfinite(v) for v in st["losses"].values()):
            raise AssertionError(f"micro-step {i}: non-finite loss")
        updates = (i + 1) % k_acc == 0
        if st["g_changed"] != updates or st["d_changed"] != updates:
            raise AssertionError(f"micro-step {i}: parameters changed "
                                 f"G {st['g_changed']} D {st['d_changed']},"
                                 f" expected {updates}")
    if len(steps) != 4 or trainer.g_opt.count != 2:
        raise AssertionError(f"{len(steps)} micro-steps, "
                             f"{trainer.g_opt.count} optimizer steps")
    # steady state: the second optimizer step's two micro-steps (step 0
    # builds the cuDNN plans, step 1 allocates the optimizers' state)
    step_ms = float(np.mean([st["ms"] for st in steps[2:]]))
    train_ips = trainer.batch_size / step_ms * 1e3
    print(f"[train] 4 micro-steps, 2 optimizer steps, launches {launches} "
          f"(per micro-step {PER_MICRO_STEP}); micro-step {step_ms:.2f} ms "
          f"(mean of steps 2-3; steps 0-1 {steps[0]['ms']:.2f}, "
          f"{steps[1]['ms']:.2f} ms), "
          f"{train_ips:.2f} imgs/s, peak memory {peak_gib:.3f} GiB | {smi}",
          flush=True)
    img = trainer.to_device(next(iter(trainer.train_dl))[0])
    train_profile = profile(torch, lambda: [step_fn(img) for _ in range(2)],
                            lambda: step_fn(img), "2 training micro-steps")

    # ---------------------------------------------------------------- 8 --
    # MaskGIT's iterative decode at cfg/maskgit.yaml's widths, bf16 compute
    # over fp32 parameters (training.mixed_precision=bf16), seeded weights
    del trainer
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mcfg = maskgit_config("bf16")
    mg = build_model(mcfg, device=dev).eval()
    depth, n_steps = mcfg.model.depth, 18
    print(f"[maskgit] build_model(cfg/maskgit.yaml, mixed_precision=bf16) on "
          f"the card in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in mg.parameters()) / 1e6:.1f} M parameters",
          flush=True)
    uncond = maskgit_service(mg, timesteps=n_steps, num_masked=1024,
                             approx_topk=True)
    services = {
        "unconditional": (uncond, {}, True, False),
        "inpainting": (maskgit_service(mg, timesteps=n_steps, num_masked=200,
                                       approx_topk=True, inpaint=True),
                       requests[0], True, True),
        "exact": (maskgit_service(mg, timesteps=n_steps, num_masked=1024),
                  {}, False, False),
    }
    mg_seeds = list(range(8))
    seeds_dev = torch.arange(8, device=dev)
    final_ids = []
    decode_real = mg.vq.decode_indices
    mg.vq.decode_indices = lambda idx: final_ids.append(idx) or decode_real(idx)

    def expected(approx, inpaint):
        want = {k: v * n_steps for k, v in maskgit_step(depth, approx).items()}
        for part in (VQ_DECODE, VQ_ENCODE) if inpaint else (VQ_DECODE,):
            for k, v in part.items():
                want[k] = want.get(k, 0) + v
        return want

    torch.cuda.synchronize()
    c = zero_counts()
    for label, (svc, inputs, approx, inpaint) in services.items():
        out = svc(inputs, mg_seeds)
        c = expect_delta(c, expected(approx, inpaint), f"maskgit {label}")
        finite = bool(torch.isfinite(out).all())
        if out.shape != (8, 3, 256, 256) or not finite:
            raise AssertionError(f"maskgit {label}: {tuple(out.shape)}, "
                                 f"finite {finite}")
    torch.cuda.synchronize()
    maskgit_launches = counts()
    print(f"[maskgit] launches over unconditional + inpainting (approx) + "
          f"exact generates, 18 steps each: {maskgit_launches} (per step "
          f"{maskgit_step(depth, True)}, tokenizer decode {VQ_DECODE}, "
          f"encode {VQ_ENCODE})", flush=True)

    # the first decode step of the inpainting request, kernels against plain:
    # its first 200 positions masked, the rest the image's own tokens
    x0 = mg.encode_to_indices(torch.as_tensor(requests[0], device=dev)).long()
    x0[:, :200] = mg.mask_token_id

    def first_step(model, kernels):
        model.use_kernels(kernels)
        with torch.inference_mode():
            lg = model.bidirectional_transformer(x0)
            epi = (sample_epilogue_fused if kernels
                   else _sample_epilogue_reference)
            picks = epi(lg, temperature=temp0, seeds=seeds_dev, step=0)
        model.use_kernels(True)
        return lg, picks

    step_bits = philox_bits(seeds_dev, 1024, 0, n_cls)
    lg_k, picks_k = first_step(mg, True)
    lg_p, picks_p = first_step(mg, False)
    lg_err = rel_l2(lg_k, lg_p)
    print(f"[maskgit] first decode step, bf16: logits rel_l2 {lg_err:.3e} "
          f"(tol {MODEL_BF16_TOL:g}); pick agreement "
          f"{float((picks_k[0] == picks_p[0]).float().mean()):.6f} (reported)",
          flush=True)
    if not lg_err <= MODEL_BF16_TOL:
        raise AssertionError(f"maskgit bf16 first-step logits: {lg_err}")
    # one full-width EncoderLayer (layer 0 of the seeded model) on the first
    # step's hidden state: its update (out - h), kernels against plain in
    # bf16, and each against the same layer in fp32 (plain, TF32 off) on the
    # same bf16 input; the kernels' error must stay near the plain path's
    bt = mg.bidirectional_transformer
    layer0 = bt.decoder.layers[0]
    with torch.inference_mode():
        mg.use_kernels(False)
        h0 = bt.init_norm(F.embedding(x0, bt.input_proj.weight).to(bt.dtype)
                          + bt.pos_enc.to(bt.dtype))
        upd32 = layer0(h0.float()) - h0.float()
        upd_p = layer0(h0).float() - h0.float()
        mg.use_kernels(True)
        upd_k = layer0(h0).float() - h0.float()
    layer_err = rel_l2(upd_k, upd_p)
    layer_floor, layer_k32 = rel_l2(upd_p, upd32), rel_l2(upd_k, upd32)
    print(f"[maskgit] layer 0 update, bf16: kernels vs plain rel_l2 "
          f"{layer_err:.3e} (tol {BF16_TOL:g}); against fp32 kernels "
          f"{layer_k32:.3e}, plain {layer_floor:.3e} (tol kernels <= "
          f"{FLOOR_RATIO:g} x plain)", flush=True)
    if not (layer_err <= BF16_TOL
            and layer_k32 <= FLOOR_RATIO * layer_floor):
        raise AssertionError(f"maskgit layer 0: {layer_err}, {layer_k32} vs "
                             f"{layer_floor}")
    del h0, upd32, upd_p, upd_k
    # the model's own bf16 sensitivity, reported beside the gate: the plain
    # path again with the embedding rows of every 97th token id scaled by
    # 1 + 2^-7 (about one bf16 ulp)
    emb = mg.bidirectional_transformer.input_proj.weight
    emb_saved = emb.detach().clone()
    with torch.no_grad():
        emb[::97] *= 1 + 2 ** -7
    lg_nudged, _ = first_step(mg, False)
    with torch.no_grad():
        emb.copy_(emb_saved)
    nudge_err = rel_l2(lg_nudged, lg_p)
    print(f"[maskgit] plain path with 1 % of the embedding rows nudged by "
          f"about one bf16 ulp: logits rel_l2 {nudge_err:.3e} (reported)",
          flush=True)
    del lg_nudged, emb_saved
    mg32 = build_model(maskgit_config("no"), device=dev).eval()  # same seed
    lg32_k, picks32_k = first_step(mg32, True)
    lg32_p, picks32_p = first_step(mg32, False)
    lg32_err = rel_l2(lg32_k, lg32_p)
    lg_k32, lg_p32 = rel_l2(lg_k, lg32_p), rel_l2(lg_p, lg32_p)
    print(f"[maskgit] first decode step, fp32 (TF32 off): logits rel_l2 "
          f"{lg32_err:.3e} (tol 1e-4); bf16 logits against them: kernels "
          f"{lg_k32:.3e}, plain {lg_p32:.3e} (tol kernels <= {FLOOR_RATIO:g}"
          f" x plain)", flush=True)
    if not lg_k32 <= FLOOR_RATIO * lg_p32:
        raise AssertionError(f"maskgit bf16 logits against fp32: kernels "
                             f"{lg_k32}, plain {lg_p32}")
    if not lg32_err <= 1e-4:
        raise AssertionError(f"maskgit fp32 first-step logits: {lg32_err}")
    epilogue_check("maskgit fp32 first step", lg32_p.reshape(-1, n_cls).float(),
                   step_bits, temp0, picks32_k, picks32_p, 1e-4,
                   relative=False, x32_got=lg32_k.reshape(-1, n_cls).float())
    del mg32, lg32_k, lg32_p, lg_k, lg_p

    # whole-generate ids, kernels against plain (reported: a flipped
    # near-tie changes every later step)
    final_ids.clear()
    uncond({}, mg_seeds)
    mg.use_kernels(False)
    t = time.perf_counter()
    uncond({}, mg_seeds)
    torch.cuda.synchronize()
    plain_gen_s = time.perf_counter() - t
    mg.use_kernels(True)
    id_agree = float((final_ids[0] == final_ids[1]).float().mean())
    print(f"[maskgit] unconditional generate, kernels vs plain: id agreement "
          f"{id_agree:.4f} (reported)", flush=True)

    def generate_s():
        torch.cuda.synchronize()
        t = time.perf_counter()
        uncond({}, mg_seeds)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    generate_s()
    gen_times = [generate_s() for _ in range(5)]
    gen_s = float(np.median(gen_times))
    torch.cuda.reset_peak_memory_stats()
    generate_s()
    mg_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    mg_ms_step, mg_ips = gen_s / n_steps * 1e3, 8 / gen_s
    print(f"[maskgit] unconditional generate, batch 8, 18 steps, bf16, "
          f"approx: {gen_s * 1e3:.2f} ms ({mg_ms_step:.3f} ms/step, "
          f"{mg_ips:.3f} images/s; median of 5, "
          f"{min(gen_times) * 1e3:.2f}-{max(gen_times) * 1e3:.2f} ms); plain "
          f"path {plain_gen_s * 1e3:.2f} ms (1 run); peak memory "
          f"{mg_peak_gib:.3f} GiB | {smi}", flush=True)
    mg_profile = profile(torch, lambda: uncond({}, mg_seeds),
                         lambda: uncond({}, mg_seeds),
                         "1 MaskGIT generate (batch 8, 18 steps)")
    mg.vq.decode_indices = decode_real
    del mg, uncond, services, bt, layer0, emb, decode_real, final_ids
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 9 --
    # MaskGIT training: build_model + build_trainer on cfg/maskgit.yaml with
    # training.mixed_precision=bf16 and MASKGIT_TRAIN_OVERRIDES
    t0 = time.perf_counter()
    tcfg = maskgit_train_config(os.path.abspath(os.path.join(
        "chiprun_out", "chip_smoke_maskgit_train")))
    mtrainer = build_trainer(tcfg, build_model(tcfg, device=dev),
                             build_loader(tcfg), dev)
    print(f"[maskgit_train] build_model + build_trainer(cfg/maskgit.yaml, "
          f"bf16, {MASKGIT_TRAIN_OVERRIDES}) in "
          f"{time.perf_counter() - t0:.1f} s; lr at optimizer step 0 "
          f"{mtrainer.schedule(0):g}", flush=True)
    mstep_fn = mtrainer.train_step
    mvq = mtrainer.model.vq
    vq0 = {k: v.clone() for k, v in mvq.state_dict().items()}
    msteps = []

    def mg_traced_step(x, **kw):
        torch.cuda.synchronize()
        before = counts()
        st = mtrainer.opt.state
        p0 = [p.detach().clone() for p in mtrainer.trainable]
        m0 = [st[p]["exp_avg"].clone() if p in st else None
              for p in mtrainer.trainable]
        t = time.perf_counter()
        m = mstep_fn(x, **kw)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        msteps.append(dict(
            ms=ms, loss=float(m["loss"]),
            launches={k: v - before[k] for k, v in counts().items()},
            changed=any(not torch.equal(a, p)
                        for a, p in zip(p0, mtrainer.trainable)),
            moments_moved=any(a is None or not torch.equal(a, st[p]["exp_avg"])
                              for a, p in zip(m0, mtrainer.trainable)),
            vq_equal=all(torch.equal(v, vq0[k])
                         for k, v in mvq.state_dict().items())))
        del p0, m0
        return m

    mtrainer.train_step = mg_traced_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    mtrainer.train()
    torch.cuda.synchronize()
    mtrain_launches = counts()
    mtrainer.train_step = mstep_fn
    mtrain_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # micro-step i: an optimizer step at i = 1 and 3; the first runs at lr 0
    # (constant_with_warmup, warmup 1000), so it moves the moments only
    want_changed = {0: False, 1: False, 2: False, 3: True}
    want_moved = {0: True, 1: True, 2: False, 3: True}
    for i, st in enumerate(msteps):
        print(f"[maskgit_train] micro-step {i}: {st['ms']:.2f} ms, loss "
              f"{st['loss']:.4f}, parameters changed {st['changed']}, Adam "
              f"moments moved {st['moments_moved']}, vq bit-equal "
              f"{st['vq_equal']}", flush=True)
        if st["launches"] != {k: MASKGIT_TRAIN_STEP.get(k, 0)
                              for k in st["launches"]}:
            raise AssertionError(f"maskgit micro-step {i}: launches "
                                 f"{st['launches']}, expected "
                                 f"{MASKGIT_TRAIN_STEP}")
        if not (np.isfinite(st["loss"]) and st["vq_equal"]
                and st["changed"] == want_changed[i]
                and st["moments_moved"] == want_moved[i]):
            raise AssertionError(f"maskgit micro-step {i}: {st}")
    vq_state = [p for p in mvq.parameters() if p in mtrainer.opt.state]
    if len(msteps) != 4 or mtrainer.opt.count != 2 or vq_state:
        raise AssertionError(f"{len(msteps)} micro-steps, "
                             f"{mtrainer.opt.count} optimizer steps, "
                             f"{len(vq_state)} vq tensors with state")
    mtrain_ms = float(np.mean([st["ms"] for st in msteps[2:]]))
    mtrain_ips = mtrainer.batch_size / mtrain_ms * 1e3
    print(f"[maskgit_train] 4 micro-steps, 2 optimizer steps, launches "
          f"{mtrain_launches} (per micro-step {MASKGIT_TRAIN_STEP}); "
          f"micro-step {mtrain_ms:.2f} ms (mean of steps 2-3; steps 0-1 "
          f"{msteps[0]['ms']:.2f}, {msteps[1]['ms']:.2f} ms), "
          f"{mtrain_ips:.2f} images/s, peak memory {mtrain_peak:.3f} GiB | "
          f"{smi}", flush=True)
    img = mtrainer.to_device(next(iter(mtrainer.train_dl))[0])
    mtrain_profile = profile(torch, lambda: [mstep_fn(img) for _ in range(2)],
                             lambda: mstep_fn(img),
                             "2 MaskGIT training micro-steps")
    del mtrainer, mvq, vq0, img
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 10 --
    # the whole model's loss and gradients in fp32 (TF32 off), kernels
    # against plain, on the same seeded weights, token grid, mask draws and
    # dropout seed; then the bf16 model's, each path against the fp32 plain
    # one (the tokenizer is held apart by phase 6: one token grid serves all)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the fp32 whole-model check")
    m32 = build_model(maskgit_config("no"), device=dev)
    idx = m32.encode_to_indices(torch.as_tensor(requests[0], device=dev))
    draw = torch.Generator(device=dev).manual_seed(11)
    mask_draws = (torch.rand(8, generator=draw, device=dev),
                  torch.rand(8, 1024, generator=draw, device=dev))

    def loss_grads(model, kernels):
        model.use_kernels(kernels)
        params = [p for k, p in model.named_parameters()
                  if not k.startswith("vq.")]
        loss = model.loss_from_indices(
            idx, deterministic=False, mask_draws=mask_draws,
            generator=torch.Generator(device=dev).manual_seed(12))
        grads = torch.autograd.grad(loss, params)
        model.use_kernels(True)
        return loss.detach().double(), [g.float() for g in grads]

    def flat(gs):
        return torch.cat([g.reshape(-1) for g in gs])

    loss32_k, g32_k = loss_grads(m32, True)
    loss32_p, g32_p = loss_grads(m32, False)
    loss32_err = float((loss32_k - loss32_p).abs() / loss32_p.abs())
    grad32_errs = [rel_l2(a, b) for a, b in zip(g32_k, g32_p)]
    print(f"[maskgit_train] fp32 whole model (TF32 off), kernels vs plain: "
          f"loss {float(loss32_k):.6f} vs {float(loss32_p):.6f}, relative "
          f"{loss32_err:.3e} (tol 1e-5); worst of {len(grad32_errs)} "
          f"gradients rel_l2 {max(grad32_errs):.3e} (tol 1e-4)", flush=True)
    if not (loss32_err <= 1e-5 and max(grad32_errs) <= 1e-4):
        raise AssertionError(f"maskgit fp32 step: loss {loss32_err}, "
                             f"gradients {max(grad32_errs)}")
    g32_flat = flat(g32_p)
    del m32, g32_k, g32_p
    m16 = build_model(maskgit_config("bf16"), device=dev)  # same seed
    ratio = {}
    for kernels in (True, False):
        loss16, g16 = loss_grads(m16, kernels)
        ratio["kernels" if kernels else "plain"] = dict(
            loss=float((loss16 - loss32_p).abs() / loss32_p.abs()),
            grad=rel_l2(flat(g16), g32_flat))
        del g16
    print(f"[maskgit_train] bf16 against the fp32 plain path: loss relative "
          f"kernels {ratio['kernels']['loss']:.3e}, plain "
          f"{ratio['plain']['loss']:.3e}; global gradient rel_l2 kernels "
          f"{ratio['kernels']['grad']:.3e}, plain {ratio['plain']['grad']:.3e}"
          f" (tol kernels <= {FLOOR_RATIO:g} x plain)", flush=True)
    for what in ("loss", "grad"):
        if not ratio["kernels"][what] <= FLOOR_RATIO * ratio["plain"][what]:
            raise AssertionError(f"maskgit bf16 {what} against fp32: {ratio}")
    del m16, g32_flat
    torch.cuda.empty_cache()

    # one micro-step of the shipped fp32 trainer (cfg/maskgit.yaml's
    # mixed_precision "no", TF32 off): what its users pay a micro-step, the
    # fp32 flash backward (kernel 5 at h 12) 16 times in it
    fcfg = maskgit_config("no")
    for key_, val in MASKGIT_TRAIN_OVERRIDES.items():
        fcfg.set_path(key_, val)
    fcfg.set_path("experiment.output_dir", os.path.abspath(os.path.join(
        "chiprun_out", "chip_smoke_maskgit_train_fp32")))
    ftrainer = build_trainer(fcfg, build_model(fcfg, device=dev),
                             build_loader(fcfg), dev)
    img = ftrainer.to_device(next(iter(ftrainer.train_dl))[0])
    ftrainer.train_step(img)  # warm-up
    torch.cuda.synchronize()
    fp32_step_ms = []
    for _ in range(2):
        c = counts()
        t = time.perf_counter()
        m = ftrainer.train_step(img)
        torch.cuda.synchronize()
        fp32_step_ms.append((time.perf_counter() - t) * 1e3)
        now = counts()
        fp32_launches = {k: now[k] - c[k] for k in now if now[k] != c[k]}
        gate(fp32_launches.get("flash_attention_bwd_kv") == 16
             and np.isfinite(float(m["loss"])),
             f"maskgit fp32 micro-step: launches {fp32_launches}, loss "
             f"{float(m['loss'])}")
    print(f"[maskgit_train] fp32 (shipped mixed_precision no, TF32 off): "
          f"micro-step {fp32_step_ms[0]:.2f} / {fp32_step_ms[1]:.2f} ms, "
          f"launches a micro-step {fp32_launches} | {smi}", flush=True)
    fp32_profile = profile(torch, lambda: ftrainer.train_step(img),
                           lambda: ftrainer.train_step(img),
                           "1 fp32 MaskGIT training micro-step")
    del ftrainer, img, m
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 11 --
    # Muse's CFG decode at cfg/muse.yaml's widths, bf16 compute over fp32
    # parameters (training.mixed_precision=bf16), seeded weights, in each
    # quant mode; the shipped "no" (fp32) in the first-step check
    text_ids = tokenize(MUSE_PROMPTS)
    mu_seeds = list(range(8))
    mu_depth = MUSE_YAML["model"]["decoder"]["depth"]
    muse_launches = {k: 0 for k in wrappers}
    muse = {}

    def use_kernels(model, kernels, ffn_only=False):
        """All kernels, none, or (``ffn_only``) the FFN kernels alone on the
        plain path's other ops."""
        model.use_kernels(kernels and not ffn_only)
        for m in model.modules():
            if ffn_only and isinstance(m, FeedForward):
                m.kernels = True

    def muse_first_step(model, kernels, ffn_only=False):
        """The first decode step of the 8 prompts (every position masked:
        1024 over the ViTVQGAN, 256 over the CNN tokenizer; the text and the
        null context in one 16-row forward): logits and the epilogue's
        picks."""
        use_kernels(model, kernels, ffn_only)
        with torch.inference_mode():
            text = model.encode_texts(torch.as_tensor(text_ids, device=dev))
            ids0 = torch.full((16, model.num_patches), model.mask_token_id,
                              device=dev)
            lg = model.decoder(ids0, torch.cat([text, torch.zeros_like(text)]))
            epi = (sample_epilogue_fused if kernels and not ffn_only
                   else _sample_epilogue_reference)
            picks = epi(*lg.chunk(2), guidance_scale=gs, p=p_keep,
                        temperature=temp0, seeds=seeds_dev, step=0)
        model.use_kernels(True)
        return lg, picks

    def muse_layer0(model):
        """Layer 0's update (out - h) on the first step's hidden state and
        context: all kernels, the FFN kernel alone and plain in the model's
        dtype; plain in fp32."""
        dec = model.decoder
        layer0, dt = dec.decoder.layers[0], dec.dtype
        upd = {}
        with torch.inference_mode():
            model.use_kernels(False)
            text = model.encode_texts(torch.as_tensor(text_ids, device=dev))
            ctx = torch.cat([text, torch.zeros_like(text)])
            ids0 = torch.full((16, model.num_patches), model.mask_token_id,
                              device=dev)
            h0 = (F.embedding(ids0, dec.token_emb.weight).to(dt)
                  + dec.pos_enc.to(dt))
            upd["fp32"] = layer0(h0.float(), ctx.float()) - h0.float()
            for way, kw in (("plain", dict(kernels=False)),
                            ("ffn", dict(kernels=False, ffn_only=True)),
                            ("kernels", dict(kernels=True))):
                use_kernels(model, **kw)
                upd[way] = layer0(h0, ctx).float() - h0.float()
        model.use_kernels(True)
        return upd

    def muse_nudged(model):
        """The plain path's first-step logits with the position rows of
        every 97th token scaled by 1 + 2^-7 (about one bf16 ulp): the
        model's own bf16 sensitivity."""
        pe = model.decoder.pos_enc
        saved = pe.detach().clone()
        with torch.no_grad():
            pe[:, ::97] *= 1 + 2 ** -7
        lg, _ = muse_first_step(model, False)
        with torch.no_grad():
            pe.copy_(saved)
        return lg

    def muse_expected(quant, approx):
        want = {k: v * 18 for k, v in muse_step(mu_depth, quant,
                                                  approx).items()}
        want["layernorm"] += CLIP_LAYERNORMS
        for k, v in VQ_DECODE.items():
            want[k] = want.get(k, 0) + v
        return want

    for label, quant in (("none", None), ("int8_wide", "int8_wide"),
                         ("int8", "int8")):
        t0 = time.perf_counter()
        mm = build_model(muse_config("bf16", quant), device=dev).eval()
        row = dict(build_s=time.perf_counter() - t0)
        svcs = {approx: muse_service(mm, timesteps=18, approx_topk=approx)
                for approx in ((True, False) if quant is None else (True,))}
        for approx, svc in svcs.items():
            torch.cuda.synchronize()
            c = zero_counts()
            out = svc(text_ids, mu_seeds)
            torch.cuda.synchronize()
            expect_delta(c, muse_expected(quant, approx),
                         f"muse {label} approx={approx}")
            for k, v in counts().items():
                muse_launches[k] += v
            finite = bool(torch.isfinite(out).all())
            gate(out.shape == (8, 3, 256, 256) and finite,
                 f"muse {label}: {tuple(out.shape)}, finite {finite}")
        print(f"[muse] {label}: build_model(cfg/muse.yaml, bf16) "
              f"{row['build_s']:.1f} s, "
              f"{sum(p.numel() for p in mm.parameters()) / 1e6:.1f} M "
              f"parameters; launches per generate "
              f"{muse_expected(quant, True)} (per step "
              f"{muse_step(mu_depth, quant, True)})", flush=True)

        # bf16, kernels against plain. Under a quant mode an ulp rounded
        # otherwise anywhere moves int8 codes, and the model's bf16 floor
        # (the nudged plain path) rises to 5-7e-2: the logits are held to
        # FLOOR_RATIO x that floor there, to 2e-2 under quant none; layer
        # 0's update with the FFN kernel alone to 1e-2 (all kernels under
        # quant none); the ratio gates against fp32 below in every mode
        lg_k, picks_k = muse_first_step(mm, True)
        lg_p, picks_p = muse_first_step(mm, False)
        lg_f, _ = muse_first_step(mm, False, ffn_only=True)
        row["first_step_logits_rel_l2_bf16"] = rel_l2(lg_k, lg_p)
        row["first_step_logits_rel_l2_bf16_ffn_kernels"] = rel_l2(lg_f, lg_p)
        row["first_step_pick_agreement_bf16"] = float(
            (picks_k[0] == picks_p[0]).float().mean())
        row["nudged_rel_l2_bf16"] = rel_l2(muse_nudged(mm), lg_p)
        lg_tol = (MODEL_BF16_TOL if quant is None
                  else FLOOR_RATIO * row["nudged_rel_l2_bf16"])
        print(f"[muse] {label} first decode step, bf16: logits rel_l2 all "
              f"kernels {row['first_step_logits_rel_l2_bf16']:.3e} (tol "
              f"{lg_tol:.3e}{'' if quant is None else ' = 1.25 x nudged'}), "
              f"the FFN kernel alone "
              f"{row['first_step_logits_rel_l2_bf16_ffn_kernels']:.3e}; "
              f"plain path with 1 % of the position rows nudged by about one "
              f"bf16 ulp {row['nudged_rel_l2_bf16']:.3e}; pick agreement "
              f"{row['first_step_pick_agreement_bf16']:.6f} (reported)",
              flush=True)
        gate(row["first_step_logits_rel_l2_bf16"] <= lg_tol,
             f"muse {label} bf16 first-step logits: "
             f"{row['first_step_logits_rel_l2_bf16']} > {lg_tol}")
        del lg_f
        upd = muse_layer0(mm)
        l0 = row["layer0_update_rel_l2_bf16"] = dict(
            kernels_vs_plain=rel_l2(upd["kernels"], upd["plain"]),
            ffn_kernel_vs_plain=rel_l2(upd["ffn"], upd["plain"]),
            kernels_vs_fp32=rel_l2(upd["kernels"], upd["fp32"]),
            plain_vs_fp32=rel_l2(upd["plain"], upd["fp32"]))
        l0_gated = l0["kernels_vs_plain" if quant is None
                      else "ffn_kernel_vs_plain"]
        print(f"[muse] {label} layer 0 update, bf16: rel_l2 all kernels vs "
              f"plain {l0['kernels_vs_plain']:.3e}, the FFN kernel alone "
              f"{l0['ffn_kernel_vs_plain']:.3e} (tol {BF16_TOL:g} on the "
              f"{'first' if quant is None else 'second'}); against fp32 "
              f"kernels {l0['kernels_vs_fp32']:.3e}, plain "
              f"{l0['plain_vs_fp32']:.3e} (tol kernels <= {FLOOR_RATIO:g} x "
              f"plain)", flush=True)
        gate(l0_gated <= BF16_TOL, f"muse {label} layer 0: {l0_gated}")
        gate(l0["kernels_vs_fp32"] <= FLOOR_RATIO * l0["plain_vs_fp32"],
             f"muse {label} layer 0 against fp32: {l0}")
        del upd

        def muse_generate_s(svc=svcs[True]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            svc(text_ids, mu_seeds)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        muse_generate_s()
        row["generate_s"] = [muse_generate_s() for _ in range(3)]
        gen_s = float(np.median(row["generate_s"]))
        torch.cuda.reset_peak_memory_stats()
        muse_generate_s()
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        row["ms_per_step"], row["images_per_s"] = gen_s / 18 * 1e3, 8 / gen_s
        exact = ""
        if False in svcs:
            row["exact_generate_s"] = muse_generate_s(svcs[False])
            exact = (f"; exact mode {row['exact_generate_s'] * 1e3:.2f} ms "
                     f"(1 run)")
        print(f"[muse] {label} generate, batch 8, 18 steps, bf16, approx: "
              f"{gen_s * 1e3:.2f} ms ({row['ms_per_step']:.3f} ms/step, "
              f"{row['images_per_s']:.3f} images/s; median of 3, "
              f"{min(row['generate_s']) * 1e3:.2f}-"
              f"{max(row['generate_s']) * 1e3:.2f} ms){exact}; peak memory "
              f"{row['peak_gib']:.3f} GiB | {smi}", flush=True)
        if quant == "int8_wide":
            row["profile"] = profile(
                torch, lambda: svcs[True](text_ids, mu_seeds),
                lambda: svcs[True](text_ids, mu_seeds),
                "1 Muse int8_wide generate (batch 8, 18 steps)")
        del mm, svcs
        torch.cuda.empty_cache()

        # the shipped fp32 ("no"), TF32 off: kernels against plain on the
        # same weights (the same seed); under a quant mode the W8A8 FFN
        # kernels alone carry the gate, the all-kernel figure is reported
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            raise AssertionError("TF32 must be off for the fp32 Muse check")
        m32 = build_model(muse_config("no", quant), device=dev).eval()
        lg32_k, picks32_k = muse_first_step(m32, True)
        lg32_p, picks32_p = muse_first_step(m32, False)
        row["first_step_logits_rel_l2_fp32"] = rel_l2(lg32_k, lg32_p)
        if quant is not None:
            lg32_k, picks32_k = muse_first_step(m32, True, ffn_only=True)
            row["first_step_logits_rel_l2_fp32_ffn_kernels"] = rel_l2(
                lg32_k, lg32_p)
        gated = rel_l2(lg32_k, lg32_p)
        row["bf16_logits_vs_fp32"] = dict(kernels=rel_l2(lg_k, lg32_p),
                                          plain=rel_l2(lg_p, lg32_p))
        r16 = row["bf16_logits_vs_fp32"]
        print(f"[muse] {label} first decode step, fp32 (TF32 off): logits "
              f"rel_l2, all kernels "
              f"{row['first_step_logits_rel_l2_fp32']:.3e}"
              + ("" if quant is None else
                 f" (reported), the W8A8 FFN kernels alone {gated:.3e}")
              + f" (tol 1e-4); bf16 logits against them: kernels "
              f"{r16['kernels']:.3e}, plain {r16['plain']:.3e} (tol kernels "
              f"<= {FLOOR_RATIO:g} x plain)", flush=True)
        gate(gated <= 1e-4, f"muse {label} fp32 first-step logits: {gated}")
        gate(r16["kernels"] <= FLOOR_RATIO * r16["plain"],
             f"muse {label} bf16 logits against fp32: {r16}")
        cond32 = [t.reshape(-1, n_cls) for t in lg32_p.chunk(2)]
        cond32_k = [t.reshape(-1, n_cls) for t in lg32_k.chunk(2)]
        epilogue_check(f"muse {label} fp32 first step", guided(*cond32),
                       step_bits, temp0, picks32_k, picks32_p, 1e-4,
                       relative=False, x32_got=guided(*cond32_k))
        muse[label] = row
        del m32, lg32_k, lg32_p, lg_k, lg_p, cond32, cond32_k
        torch.cuda.empty_cache()
    print(f"[muse] launches over the four generates: {muse_launches}",
          flush=True)

    # --------------------------------------------------------------- 12 --
    # the tokenizer under model.quant int8 (bf16, batch 8, 256 px) on the
    # serving path, against the unquantized model of the same seed
    model_q = vitvqgan_base(img_size=256, dtype=torch.bfloat16, device=dev,
                            quant="int8")
    recon_q = vq_recon_service(model_q)
    per_recon_q = {"flash_attention_bthd_kv": 12, "ln_mlp_q8": 12,
                   "layernorm": 16, "nearest_codes": 1}
    torch.cuda.synchronize()
    c = zero_counts()
    recs_q = []
    for r in requests:
        recs_q.append(recon_q(r, None))
        c = expect_delta(c, per_recon_q, "int8 recon request")
    torch.cuda.synchronize()
    recon_int8_launches = counts()
    finite = all(bool(torch.isfinite(t).all()) for t in recs_q)
    gate(recs_q[0].shape == (8, 3, 256, 256) and finite,
         f"int8 recon: {tuple(recs_q[0].shape)}, finite {finite}")
    recon_q(requests[0], None)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(10):
        recon_q(requests[i % 3], None)
    torch.cuda.synchronize()
    q_ips = 80 / (time.perf_counter() - t)
    model_b = vitvqgan_base(img_size=256, dtype=torch.bfloat16, device=dev)
    idx_q = vq_encode_service(model_q)(requests[0], None)
    idx_b = vq_encode_service(model_b)(requests[0], None)
    q_agree = float((idx_q == idx_b).float().mean())
    print(f"[recon_int8] launches over 3 recon requests: "
          f"{recon_int8_launches} (per request {per_recon_q}); recon "
          f"{q_ips:.2f} imgs/s, batch 8, 256 px, bf16; index agreement with "
          f"the unquantized model {q_agree:.4f} (reported) | {smi}",
          flush=True)
    del model_q, model_b, recs_q

    # --------------------------------------------------------------- 13 --
    # the width repairs on a training path: one bf16 micro-step of
    # cfg_exp/vitvqgan_overfit.yaml (dim 64: every block's LayerNorm + MLP
    # composition; code width 8). LayerNorms: the patch norms, both
    # pre_norms, norm1 and norm2 of the one block of each tower
    from attention_models_torch.utils.config import Config

    ocfg = Config(json.loads(json.dumps(VQGAN_OVERFIT_YAML)))
    ocfg.set_path("training.mixed_precision", "bf16")
    ocfg.set_path("experiment.output_dir", os.path.abspath(os.path.join(
        "chiprun_out", "chip_smoke_overfit")))
    otr = build_trainer(ocfg, build_model(ocfg), build_loader(ocfg), dev)
    oimg = otr.to_device(next(iter(otr.train_dl))[0])
    c = counts()
    om = otr.train_step(oimg)
    torch.cuda.synchronize()
    expect_delta(c, {"layernorm": 8, "nearest_codes": 1},
                 "vitvqgan_overfit bf16 micro-step")
    gate(all(math.isfinite(float(v)) for v in om.values()),
         f"vitvqgan_overfit bf16 micro-step: {om}")
    print(f"[repairs] cfg_exp/vitvqgan_overfit.yaml bf16 micro-step (dim 64, "
          f"code width 8): " + ", ".join(f"{k} {float(v):.4f}"
                                         for k, v in om.items()), flush=True)
    del otr, oimg

    # ViT on cfg/vit.yaml (VIT_YAML, cut in scale only: synthetic labelled
    # images, batch 64, 256 px): eval forward, then 4 training micro-steps
    # at the shipped dropout 0.1 and 4 at dropout 0
    vit_out = os.path.abspath(os.path.join("chiprun_out", "chip_smoke_vit"))
    vcfg = vit_config(None, vit_out)
    t0 = time.perf_counter()
    vit = build_model(vcfg, device=dev).eval()
    vdl = build_loader(vcfg)
    vimg_np, vtgt_np = next(iter(vdl[0]))
    vimg = torch.as_tensor(vimg_np, device=dev)
    print(f"[vit] build_model(cfg/vit.yaml, {VIT_OVERRIDES}) in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in vit.parameters()) / 1e6:.1f} M parameters",
          flush=True)
    torch.cuda.synchronize()
    c = zero_counts()
    with torch.no_grad():
        lg_k = vit(vimg)
        c = expect_delta(c, VIT_FORWARD, "ViT eval forward")
        vit.use_kernels(False)
        lg_p = vit(vimg)
        vit.use_kernels(True)
    vit_err = rel_l2(lg_k, lg_p)
    gate(lg_k.shape == (64, 1000) and bool(torch.isfinite(lg_k).all()),
         f"ViT logits {tuple(lg_k.shape)}")
    # the fp32 model of the same seed (the plain path, TF32 off)
    vit32 = build_model(vit_config(None, vit_out, "no"), device=dev).eval()
    with torch.no_grad():
        lg32 = vit32.use_kernels(False)(vimg)
    vit_k32, vit_p32 = rel_l2(lg_k, lg32), rel_l2(lg_p, lg32)
    print(f"[vit] eval forward (batch 64, bf16): launches {VIT_FORWARD}; "
          f"logits kernels vs plain rel_l2 {vit_err:.3e} (tol "
          f"{MODEL_BF16_TOL:g}); against the fp32 plain logits kernels "
          f"{vit_k32:.3e}, plain {vit_p32:.3e} (tol kernels <= "
          f"{FLOOR_RATIO:g} x plain)", flush=True)
    gate(vit_err <= MODEL_BF16_TOL, f"ViT bf16 logits: {vit_err}")
    gate(vit_k32 <= FLOOR_RATIO * vit_p32,
         f"ViT bf16 logits against fp32: {vit_k32} vs {vit_p32}")

    def eval_ips(model, imgs, iters=10):
        """Images a second over ``iters`` no-grad forwards after one."""
        with torch.no_grad():
            model(imgs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                model(imgs)
            torch.cuda.synchronize()
        return imgs.shape[0] * iters / (time.perf_counter() - t)

    vit_ips = eval_ips(vit, vimg)
    vit.use_kernels(False)
    vit_plain_ips = eval_ips(vit, vimg)
    vit.use_kernels(True)
    expect_delta(c, {k: 11 * v for k, v in VIT_FORWARD.items()},
                 "ViT eval throughput (11 forwards)")
    print(f"[vit] eval throughput, batch 64, 256 px, bf16: kernels "
          f"{vit_ips:.2f} imgs/s, plain {vit_plain_ips:.2f} imgs/s | {smi}",
          flush=True)
    del vit, vit32, lg_k, lg_p, lg32
    torch.cuda.empty_cache()

    def vit_train(dropout, config=vit_config, out_dir=vit_out,
                  forward=VIT_FORWARD, tag="vit_train", label="ViT"):
        """4 micro-steps of VitTrainer.train() on cfg/vit.yaml (or the
        ``config``'s) with VIT_OVERRIDES and the dropout; exact launch
        deltas per micro-step (``forward``, kernel 7 only without dropout,
        then with kernel 8), finite losses; ms, imgs/s, peak memory."""
        cfg = config(dropout, out_dir)
        cfg.set_path("experiment.eval_every", 3)  # after the last micro-step
        dropout = float(cfg.model.transformer.dropout)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() / 2 ** 30  # by earlier phases
        tr = build_trainer(cfg, build_model(cfg, device=dev),
                           build_loader(cfg), dev)
        fn, rows, accs = tr.train_step, [], []
        evaluate = tr.evaluate
        tr.evaluate = lambda: accs.append(evaluate())
        want = {k: v for k, v in forward.items()
                if k != "mlp" or dropout == 0.0}
        if dropout == 0.0 and "mlp" in forward:
            want["mlp_bwd"] = forward["mlp"]
        tr.train_step = traced(fn, rows, ("loss", "acc"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr.train()
        torch.cuda.synchronize()
        tr.train_step = fn
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for i, st in enumerate(rows):
            print(f"[{tag}] dropout {dropout:g} micro-step {i}: "
                  f"{st['ms']:.2f} ms, loss {st['loss']:.4f}, acc "
                  f"{st['acc']:.4f}", flush=True)
            gate(st["launches"] == {k: want.get(k, 0) for k in wrappers},
                 f"{label} micro-step {i} (dropout {dropout}): launches "
                 f"{st['launches']}, expected {want}")
            gate(math.isfinite(st["loss"]), f"{label} micro-step {i}: loss")
        gate(len(rows) == 4 and tr.opt.count == 4 and len(accs) == 1,
             f"{len(rows)} {label} micro-steps, {tr.opt.count} optimizer "
             f"steps, {len(accs)} evaluations")
        ms = float(np.mean([st["ms"] for st in rows[2:]]))
        print(f"[{tag}] dropout {dropout:g}: launches per micro-step "
              f"{want}; micro-step {ms:.2f} ms (mean of steps 2-3; steps 0-1 "
              f"{rows[0]['ms']:.2f}, {rows[1]['ms']:.2f} ms), "
              f"{64 / ms * 1e3:.2f} imgs/s, peak memory {peak:.3f} GiB "
              f"({held:.3f} GiB of it held by earlier phases); "
              f"evaluate() after step 3: val_acc {accs[0]:.4f} over "
              f"{len(tr.val_dl.dataset)} images (one ragged batch) | {smi}",
              flush=True)
        return tr, dict(steps=rows, step_ms=ms, imgs_per_s=64 / ms * 1e3,
                        peak_gib=peak, held_gib=held, val_acc=accs[0])

    tr, vit_train_drop = vit_train(None)
    del tr
    tr, vit_train_nodrop = vit_train(0.0)
    vit_launches = counts()
    vtgt = tr.labels(vtgt_np)
    tr.model.eval()
    with torch.no_grad():
        eval_profile = profile(
            torch, lambda: [tr.model(vimg) for _ in range(2)],
            lambda: tr.model(vimg), "2 ViT eval forwards")
    tr.model.train()
    vit_train_profile = profile(
        torch, lambda: [tr.train_step(vimg, vtgt) for _ in range(2)],
        lambda: tr.train_step(vimg, vtgt), "2 ViT training micro-steps "
        "(dropout 0)")
    del tr
    torch.cuda.empty_cache()

    # one fp32 step's loss and gradients (TF32 off), kernels against plain,
    # at dropout 0.1 from one generator seed on both paths
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the fp32 ViT step")
    m32 = build_model(vit_config(None, vit_out, "no"), device=dev)

    def vit_loss_grads(kernels):
        m32.use_kernels(kernels)
        drop = torch.Generator(device=dev).manual_seed(21)
        loss = F.cross_entropy(m32(vimg, deterministic=False, generator=drop)
                               .float(), vtgt)
        grads = torch.autograd.grad(loss, list(m32.parameters()))
        m32.use_kernels(True)
        return loss.detach().double(), grads

    vl_k, vg_k = vit_loss_grads(True)
    vl_p, vg_p = vit_loss_grads(False)
    vit32_loss = float((vl_k - vl_p).abs() / vl_p.abs())
    vit32_grads = [rel_l2(a, b) for a, b in zip(vg_k, vg_p)]
    print(f"[vit] fp32 step (TF32 off), kernels vs plain: loss relative "
          f"{vit32_loss:.3e} (tol 1e-5); worst of {len(vit32_grads)} "
          f"gradients rel_l2 {max(vit32_grads):.3e} (tol 1e-4)", flush=True)
    gate(vit32_loss <= 1e-5 and max(vit32_grads) <= 1e-4,
         f"ViT fp32 step: loss {vit32_loss}, gradients {max(vit32_grads)}")
    del m32, vg_k, vg_p
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 14 --
    # the long-context workload (bench.py's long-context proof on the
    # port): causal flash attention, b 1, h 8, d 64, bf16, t 4096 / 8192 /
    # 16384, forward and forward + backward through flash_attention
    torch.cuda.synchronize()
    c = zero_counts()
    lc_rows = longcontext()
    calls_f = sum(r["fwd_calls"] + r["fwd_bwd_calls"] for r in lc_rows)
    calls_b = sum(r["fwd_bwd_calls"] for r in lc_rows)
    c = expect_delta(c, {"flash_forward": calls_f, "flash_bwd_dkv": calls_b,
                         "flash_bwd_dq": calls_b}, "long context")
    longcontext_launches = counts()
    for r in lc_rows:
        t = r["t"]
        q, k, v = make_inputs(t, device=dev)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(*leaves, is_causal=True)
            return torch.autograd.grad(o.float().sum(), leaves)

        r["sdpa_fwd_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters=10)
        r["sdpa_fwd_bwd_ms"] = time_ms(lib_fwd_bwd, iters=5)
        pairs = 8 * t * (t + 1) // 2
        r["fwd_bound_ms"] = 4 * pairs * 64 / PEAK_FLOPS["bfloat16"] * 1e3
        r["fwd_bwd_bound_ms"] = 14 * pairs * 64 / PEAK_FLOPS["bfloat16"] * 1e3
        print(f"[longcontext] t {t}: forward {r['fwd_ms']:.4f} ms (SDPA "
              f"{r['sdpa_fwd_ms']:.4f}, bound {r['fwd_bound_ms']:.4f}), "
              f"forward + backward {r['fwd_bwd_ms']:.4f} ms (SDPA "
              f"{r['sdpa_fwd_bwd_ms']:.4f}, bound {r['fwd_bwd_bound_ms']:.4f}"
              f" as the split computes it), peak above the inputs "
              f"{r['peak_bytes'] / 2 ** 20:.1f} MiB | {smi}", flush=True)
    gate(lc_rows[-1]["t"] == 16384
         and lc_rows[-1]["peak_bytes"] < 2 ** 30,
         f"long context: peak {lc_rows[-1]['peak_bytes']} B at t 16384")
    # t 16384 against the plain version, 1024 query rows at a time (the
    # whole (t, t) fp32 score matrix would take 8 GiB a product)
    out = flash_attention(*leaves, causal=True)
    lc_grads = torch.autograd.grad(out.float().sum(), leaves)
    out = out.detach()
    out_p, lse_p = _flash_forward_reference(q, k, v, 0.125, True, chunk=1024)
    ones = torch.ones_like(out)
    grads_p = _flash_backward_heads_reference(q, k, v, out_p, lse_p, ones,
                                              0.125, True, chunk=1024)
    lc_err = dict(out=rel_l2(out, out_p),
                  **{f"d{n}": rel_l2(a, b) for n, a, b in zip(
                      "qkv", lc_grads, grads_p)})
    print(f"[longcontext] t 16384 kernels vs the chunked plain version: "
          f"{lc_err} (tol forward {BF16_TOL:g}, gradients "
          f"{BWD_BF16_TOL:g})", flush=True)
    gate(lc_err["out"] <= BF16_TOL
         and all(lc_err[f"d{n}"] <= BWD_BF16_TOL for n in "qkv")
         and all(bool(torch.isfinite(x).all()) for x in (out, *lc_grads)),
         f"long context t 16384: {lc_err}")
    del q, k, v, leaves, out, out_p, lse_p, ones, grads_p, lc_grads
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 15 --
    # ring attention over 4 virtual shards: b 1, h 8, t 16384 (4096 a
    # shard), d 64, bf16, non-causal and causal, forward and backward;
    # against the full-length kernels 16/17/18, then in fp32 at t 4096
    # against the plain full-length attention
    n_ring, rt = 4, 16384
    c = zero_counts()
    ring_runs = {}
    for causal in (False, True):
        q, k, v, g = (randn(1, h_, rt, d_, dtype=torch.bfloat16)
                      for _ in range(4))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = ring_flash_attention(*leaves, n_ring, causal=causal)
        c = expect_delta(c, {"flash_forward": n_ring ** 2},
                         f"ring forward causal={causal}")
        grads = torch.autograd.grad(out, leaves, g)
        c = expect_delta(c, {"flash_bwd_dkv": n_ring ** 2,
                             "flash_bwd_dq": n_ring ** 2},
                         f"ring backward causal={causal}")
        ring_runs[causal] = (q, k, v, g, out.detach(), grads)
    ring_launches = counts()
    ring = {}
    for causal, (q, k, v, g, out, grads) in ring_runs.items():
        full = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out_f = flash_attention(*full, causal=causal)
        grads_f = torch.autograd.grad(out_f, full, g)
        errs = dict(out=rel_l2(out, out_f),
                    **{f"d{n}": rel_l2(a, b)
                       for n, a, b in zip("qkv", grads, grads_f)})
        finite = all(bool(torch.isfinite(x).all()) for x in (out, *grads))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        fwd_ms = time_ms(lambda: ring_flash_attention(
            q, k, v, n_ring, causal=causal), iters=5)
        fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(
            ring_flash_attention(*leaves, n_ring, causal=causal), leaves, g),
            iters=3)
        full_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal),
                          iters=5)
        ring[f"causal={causal}"] = dict(rel_l2=errs, finite=finite,
                                        fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms,
                                        full_fwd_ms=full_ms)
        print(f"[ring] n {n_ring}, b1 h{h_} t{rt} d{d_} bf16 causal={causal}"
              f" against the full-length kernels: {errs} (tol forward "
              f"{BF16_TOL:g}, gradients {BWD_BF16_TOL:g}), finite {finite}; "
              f"ring forward {fwd_ms:.4f} ms (full-length kernel 16 "
              f"{full_ms:.4f}), forward + backward {fwd_bwd_ms:.4f} ms | "
              f"{smi}", flush=True)
        gate(finite and errs["out"] <= BF16_TOL
             and all(errs[f"d{n}"] <= BWD_BF16_TOL for n in "qkv"),
             f"ring causal={causal}: {errs}, finite {finite}")
    del ring_runs, q, k, v, g, out, grads, full, out_f, grads_f, leaves
    torch.cuda.empty_cache()
    for causal in (False, True):
        q, k, v, g = (randn(1, h_, 4096, d_) for _ in range(4))
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = ring_flash_attention(*leaves, n_ring, causal=causal)
        grads = torch.autograd.grad(out, leaves, g)
        out_p, lse_p = _flash_forward_reference(q, k, v, 0.125, causal)
        grads_p = _flash_backward_heads_reference(q, k, v, out_p, lse_p, g,
                                                  0.125, causal)
        errs = dict(out=rel_l2(out, out_p),
                    **{f"d{n}": rel_l2(a, b)
                       for n, a, b in zip("qkv", grads, grads_p)})
        finite = all(bool(torch.isfinite(x).all()) for x in (out, *grads))
        ring[f"fp32 causal={causal}"] = dict(rel_l2=errs, finite=finite)
        print(f"[ring] n {n_ring}, b1 h{h_} t4096 d{d_} fp32 causal={causal}"
              f" against the plain full-length attention: {errs} (tol "
              f"{F32_TOL:g}), finite {finite}", flush=True)
        gate(finite and max(errs.values()) <= F32_TOL,
             f"ring fp32 causal={causal}: {errs}")
    del q, k, v, g, leaves, out, grads, out_p, lse_p, grads_p

    # --------------------------------------------------------------- 16 --
    # the separate-k/v API (kernels 9 and 10; SwitchHeadAttention calls it
    # in phase 18): flash_attention_bthd at the recon shape, bf16, forward
    # + backward through its autograd Function, then one no-grad forward
    c = zero_counts()
    q, k, v, g = (randn(b_, t_, h_, d_, dtype=torch.bfloat16)
                  for _ in range(4))
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out, _ = flash_attention_bthd(*leaves)
    grads = torch.autograd.grad(out, leaves, g)
    c = expect_delta(c, {"flash_attention_bthd": 1,
                         "flash_attention_bwd_bthd": 1},
                     "flash_attention_bthd forward + backward")
    with torch.no_grad():
        out_d, _ = flash_attention_bthd(q, k, v)
    c = expect_delta(c, {"flash_attention_bthd": 1},
                     "flash_attention_bthd no-grad forward")
    bthd_launches = counts()
    plain = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    out_p, _ = _flash_bthd_reference(*plain, scale, False)
    grads_p = torch.autograd.grad(out_p, plain, g.float())
    bthd_errs = dict(out=rel_l2(out, out_p), direct=rel_l2(out_d, out_p),
                     **{f"d{n}": rel_l2(a, b)
                        for n, a, b in zip("qkv", grads, grads_p)})
    print(f"[bthd] flash_attention_bthd b{b_} t{t_} h{h_} d{d_} bf16 "
          f"through autograd against the fp32 plain attention: {bthd_errs} "
          f"(tol forward {BF16_TOL:g}, gradients {BWD_BF16_TOL:g})",
          flush=True)
    gate(bthd_errs["out"] <= BF16_TOL and bthd_errs["direct"] <= BF16_TOL
         and all(bthd_errs[f"d{n}"] <= BWD_BF16_TOL for n in "qkv"),
         f"flash_attention_bthd: {bthd_errs}")
    del q, k, v, g, leaves, out, grads, out_d, plain, out_p, grads_p
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 17 --
    # ViT-MoE on cfg/vit_moe.yaml (VIT_MOE_YAML with VIT_OVERRIDES, cut in
    # scale only: synthetic labelled images, batch 64, 256 px, bf16): the
    # eval forward (kernel 3 only; the dispatch is PyTorch), the pairs each
    # MoE drops, imgs/s; 4 training micro-steps at the shipped dropout 0.1
    # and 4 at dropout 0; one fp32 micro-step, kernels vs plain
    from attention_models_torch.models.attention import (
        AgentAttention, SwitchHeadAttention)
    from attention_models_torch.ops.moe import expert_slots, topk_gate

    moe_out = os.path.abspath(os.path.join("chiprun_out",
                                           "chip_smoke_vit_moe"))
    mcfg = vit_moe_config(None, moe_out)
    n_exp = int(mcfg.model.transformer.n_experts)
    t0 = time.perf_counter()
    vmoe = build_model(mcfg, device=dev).eval()
    mimg_np, mtgt_np = next(iter(build_loader(mcfg)[0]))
    mimg = torch.as_tensor(mimg_np, device=dev)
    print(f"[vit_moe] build_model(cfg/vit_moe.yaml, {VIT_OVERRIDES}) in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in vmoe.parameters()) / 1e6:.1f} M "
          f"parameters", flush=True)

    def gates(model):
        """Every gate Linear by (block, MoE): the V MoE's W_s.0, the output
        MoE's W_d.0, the FFN MoE's gate."""
        return {(i, name): lin for i, blk in enumerate(model.encoder.layers)
                for name, lin in (("v", blk.self_attn.W_s[0]),
                                  ("out", blk.self_attn.W_d[0]),
                                  ("ffn", blk.moe.gate))}

    def routed(model, run, pinned=None):
        """``run()``'s result and every gate's logits in it. With
        ``pinned`` (logits by gate) each gate's output takes the pinned
        value (its gradient still reaches the gate's weight), so the
        routing is the pinned run's."""
        got, hooks = {}, []
        for key, lin in gates(model).items():
            def hook(m, a, o, key=key):
                if pinned is not None:
                    o = pinned[key].to(o.dtype) + (o - o.detach())
                got[key] = o.detach()
                return o
            hooks.append(lin.register_forward_hook(hook))
        try:
            return run(), got
        finally:
            for hk in hooks:
                hk.remove()

    def selections(logits):
        """Each gate's top-2 experts (b, t, heads, 2) by gate."""
        return {key: topk_gate(v.unflatten(-1, (-1, n_exp)), 2)[1]
                for key, v in logits.items()}

    def flips(a, b):
        """(token, head) routing decisions that differ between two runs'
        gate logits, and all decisions."""
        sa, sb = selections(a), selections(b)
        return (sum(int((sa[k] != sb[k]).any(-1).sum()) for k in sa),
                sum(v[..., 0].numel() for v in sa.values()))

    # free routing: both paths route on their own gate logits; pinned: the
    # plain path takes the kernel path's gate logits, so the two differ
    # only by the kernels' rounding (a one-ulp difference in a LayerNorm
    # output flips decisions at near ties, and a flipped decision moves its
    # token's output by O(1))
    torch.cuda.synchronize()
    c = zero_counts()
    with torch.no_grad():
        lg_k, moe_gates = routed(vmoe, lambda: vmoe(mimg))
        c = expect_delta(c, VIT_MOE_FORWARD, "ViT-MoE eval forward")
        vmoe.use_kernels(False)
        lg_p, gates_p = routed(vmoe, lambda: vmoe(mimg))
        lg_pp, _ = routed(vmoe, lambda: vmoe(mimg), moe_gates)
        vmoe.use_kernels(True)
        c = expect_delta(c, {}, "ViT-MoE plain forwards")
    moe_free_err, moe_err = rel_l2(lg_k, lg_p), rel_l2(lg_k, lg_pp)
    moe_flips = flips(moe_gates, gates_p)
    gate(lg_k.shape == (64, 1000) and bool(torch.isfinite(lg_k).all()),
         f"ViT-MoE logits {tuple(lg_k.shape)}")
    vmoe32 = build_model(vit_moe_config(None, moe_out, "no"),
                         device=dev).eval()
    with torch.no_grad():
        lg32, gates32 = routed(vmoe32, lambda: vmoe32.use_kernels(False)(
            mimg))
        lg_k_pin, _ = routed(vmoe, lambda: vmoe(mimg), gates32)
        vmoe.use_kernels(False)
        lg_p_pin, _ = routed(vmoe, lambda: vmoe(mimg), gates32)
        vmoe.use_kernels(True)
    c = expect_delta(c, VIT_MOE_FORWARD, "ViT-MoE forward on fp32 routing")
    moe_k32, moe_p32 = rel_l2(lg_k_pin, lg32), rel_l2(lg_p_pin, lg32)
    moe_free32 = dict(kernels=rel_l2(lg_k, lg32), plain=rel_l2(lg_p, lg32))
    moe_flips32 = dict(kernels=flips(moe_gates, gates32),
                       plain=flips(gates_p, gates32))
    print(f"[vit_moe] eval forward (batch 64, bf16): launches "
          f"{VIT_MOE_FORWARD}; logits kernels vs plain on the same routing "
          f"rel_l2 {moe_err:.3e} (tol {MODEL_BF16_TOL:g}); with free routing "
          f"{moe_free_err:.3e}, {moe_flips[0]} of {moe_flips[1]} (token, "
          f"head) decisions differing (reported); on the fp32 plain path's "
          f"routing, against its logits, kernels {moe_k32:.3e}, plain "
          f"{moe_p32:.3e} (tol kernels <= {FLOOR_RATIO:g} x plain); free: "
          f"kernels {moe_free32['kernels']:.3e}, plain "
          f"{moe_free32['plain']:.3e}, decisions differing from fp32's "
          f"{moe_flips32['kernels'][0]} / {moe_flips32['plain'][0]} "
          f"(reported)", flush=True)
    gate(moe_err <= MODEL_BF16_TOL, f"ViT-MoE bf16 logits: {moe_err}")
    gate(moe_k32 <= FLOOR_RATIO * moe_p32,
         f"ViT-MoE bf16 logits against fp32: {moe_k32} vs {moe_p32}")
    moe_sel = selections(moe_gates)
    del vmoe32, lg32, lg_p, lg_pp, lg_k_pin, lg_p_pin, gates_p, gates32
    cf = float(mcfg.model.transformer.capacity_factor)
    moe_drops = []
    for i in range(len(vmoe.encoder.layers)):
        row = {}
        for moe_name in ("ffn", "out"):
            _, keep, cap = expert_slots(moe_sel[(i, moe_name)], n_exp, cf)
            row[moe_name] = dict(dropped=int((~keep).sum()),
                                 pairs=keep.numel(), capacity=cap)
        moe_drops.append(row)
        print(f"[vit_moe] layer {i} pairs dropped at capacity factor {cf:g}:"
              f" FFN MoE {row['ffn']['dropped']} of {row['ffn']['pairs']} "
              f"(capacity {row['ffn']['capacity']} an expert), output MoE "
              f"{row['out']['dropped']} of {row['out']['pairs']} (capacity "
              f"{row['out']['capacity']})", flush=True)

    torch.cuda.synchronize()
    moe_eval_held = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    moe_ips = eval_ips(vmoe, mimg)
    moe_eval_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vmoe.use_kernels(False)
    moe_plain_ips = eval_ips(vmoe, mimg)
    vmoe.use_kernels(True)
    expect_delta(c, {k: 11 * v for k, v in VIT_MOE_FORWARD.items()},
                 "ViT-MoE eval throughput (11 forwards)")
    print(f"[vit_moe] eval throughput, batch 64, 256 px, bf16: kernels "
          f"{moe_ips:.2f} imgs/s, plain {moe_plain_ips:.2f} imgs/s; peak "
          f"memory {moe_eval_peak:.3f} GiB ({moe_eval_held:.3f} GiB of it "
          f"held before the forwards: the model, its inputs and earlier "
          f"phases) | {smi}", flush=True)
    del vmoe, lg_k
    torch.cuda.empty_cache()

    tr, moe_train_drop = vit_train(None, vit_moe_config, moe_out,
                                   VIT_MOE_FORWARD, "vit_moe_train",
                                   "ViT-MoE")
    del tr
    tr, moe_train_nodrop = vit_train(0.0, vit_moe_config, moe_out,
                                     VIT_MOE_FORWARD, "vit_moe_train",
                                     "ViT-MoE")
    moe_launches = counts()
    mtgt = tr.labels(mtgt_np)
    tr.model.eval()
    with torch.no_grad():
        moe_eval_profile = profile(
            torch, lambda: [tr.model(mimg) for _ in range(2)],
            lambda: tr.model(mimg), "2 ViT-MoE eval forwards")
    tr.model.train()
    moe_train_profile = profile(
        torch, lambda: [tr.train_step(mimg, mtgt) for _ in range(2)],
        lambda: tr.train_step(mimg, mtgt), "2 ViT-MoE training micro-steps "
        "(dropout 0)")
    del tr
    torch.cuda.empty_cache()

    # one fp32 step's loss and gradients (TF32 off), kernels against plain,
    # at dropout 0.1 from one generator seed on both paths, the plain path
    # on the kernel path's routing (its gate logits pinned; the routing
    # decisions a free plain step takes otherwise are counted and its
    # figures reported); W_d.0 gets no gradient on either path (the
    # unweighted output MoE)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the fp32 ViT-MoE step")
    m32 = build_model(vit_moe_config(None, moe_out, "no"), device=dev)
    m32_names = [k for k, _ in m32.named_parameters()]

    def moe_loss_grads(kernels, pinned=None):
        m32.use_kernels(kernels)
        drop = torch.Generator(device=dev).manual_seed(21)
        loss, logits = routed(m32, lambda: F.cross_entropy(
            m32(mimg, deterministic=False, generator=drop).float(), mtgt),
            pinned)
        grads = torch.autograd.grad(loss, list(m32.parameters()),
                                    allow_unused=True)
        m32.use_kernels(True)
        return loss.detach().double(), grads, logits

    def step_errs(a, b):
        (la, ga, _), (lb, gb, _) = a, b
        return (float((la - lb).abs() / lb.abs()),
                {n: rel_l2(x, y) for n, x, y in zip(m32_names, ga, gb)
                 if x is not None})

    step_k = moe_loss_grads(True)
    moe32_loss, moe32_grads = step_errs(step_k, moe_loss_grads(False,
                                                               step_k[2]))
    step_free = moe_loss_grads(False)
    moe32_free = step_errs(step_k, step_free)
    moe32_flips = flips(step_k[2], step_free[2])
    unused = [n for n, a in zip(m32_names, step_k[1]) if a is None]
    print(f"[vit_moe] fp32 step (TF32 off), kernels vs plain on the same "
          f"routing: loss relative {moe32_loss:.3e} (tol 1e-5); worst of "
          f"{len(moe32_grads)} gradients rel_l2 "
          f"{max(moe32_grads.values()):.3e} (tol 1e-4), "
          f"{max(moe32_grads, key=moe32_grads.get)}; no gradient: "
          f"{len(unused)} (the W_d.0 gates); with free routing "
          f"{moe32_flips[0]} of {moe32_flips[1]} (token, head) decisions "
          f"differ, loss {moe32_free[0]:.3e}, worst gradient "
          f"{max(moe32_free[1].values()):.3e} (reported)", flush=True)
    gate(unused == [n for n in m32_names if ".W_d.0." in n]
         and len(unused) == 6
         and all(b is None for n, b in zip(m32_names, step_free[1])
                 if n in unused),
         f"ViT-MoE fp32 step: parameters without a gradient {unused}")
    gate(moe32_loss <= 1e-5 and max(moe32_grads.values()) <= 1e-4,
         f"ViT-MoE fp32 step: loss {moe32_loss}, gradients {moe32_grads}")
    del step_k, step_free
    del m32
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 18 --
    # SwitchHeadAttention at a flash-sized length, ViT-MoE's width: b 8,
    # t 1024, dim 1024, 16 x 64 heads, E 32, top-2, capacity factor 2.0,
    # bf16 over fp32 parameters: kernel 9 forward and kernel 10 backward
    # launched by the module, against the module on the plain attention
    # (the routing reads the module's input, so both paths route alike)
    torch.manual_seed(0)
    sw = SwitchHeadAttention(1024, 16, 64, 32, 2,
                             capacity_factor=2.0).to(dev)
    xs = randn(8, 1024, 1024, dtype=torch.bfloat16)
    gs = randn(8, 1024, 1024, dtype=torch.bfloat16)
    sw_names = ["dx"] + [k for k, _ in sw.named_parameters()]

    def sw_grads(kernels):
        sw.kernels = kernels
        xr = xs.clone().requires_grad_(True)
        out = sw(xr)
        grads = torch.autograd.grad(out, [xr, *sw.parameters()], gs,
                                    allow_unused=True)
        sw.kernels = True
        return out.detach(), grads

    c = zero_counts()
    sw_out_k, sw_g_k = sw_grads(True)
    c = expect_delta(c, {"flash_attention_bthd": 1,
                         "flash_attention_bwd_bthd": 1},
                     "SwitchHeadAttention forward + backward")
    switchhead_launches = counts()
    sw_out_p, sw_g_p = sw_grads(False)
    c = expect_delta(c, {}, "SwitchHeadAttention on the plain attention")
    sw_errs = {"out": rel_l2(sw_out_k, sw_out_p),
               **{n: rel_l2(a, b) for n, a, b in zip(sw_names, sw_g_k,
                                                      sw_g_p)
                  if a is not None}}
    sw_unused = [n for n, a in zip(sw_names, sw_g_k) if a is None]
    with torch.no_grad():
        sw_ms = time_ms(lambda: sw(xs), iters=10)
        sw.kernels = False
        sw_plain_ms = time_ms(lambda: sw(xs), iters=10)
        sw.kernels = True
    zero_counts()
    print(f"[switchhead] b8 t1024 dim 1024 h16 d64 E32 k2 cf2 bf16, kernels "
          f"9 / 10 vs the plain attention: output {sw_errs['out']:.3e} (tol "
          f"{BF16_TOL:g}), worst gradient "
          f"{max(v for k, v in sw_errs.items() if k != 'out'):.3e} (tol "
          f"{BWD_BF16_TOL:g}) of {len(sw_errs) - 1}, no gradient "
          f"{sw_unused}; forward {sw_ms:.3f} ms (plain attention "
          f"{sw_plain_ms:.3f}) | {smi}", flush=True)
    gate(bool(torch.isfinite(sw_out_k).all())
         and sw_errs["out"] <= BF16_TOL
         and all(v <= BWD_BF16_TOL for k, v in sw_errs.items() if k != "out")
         and sw_unused == ["W_d.0.weight"],
         f"SwitchHeadAttention at t 1024: {sw_errs}, no gradient "
         f"{sw_unused}")
    del sw, xs, gs, sw_g_k, sw_g_p, sw_out_k, sw_out_p
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 19 --
    # AgentAttention (no kernel; a path check): dim 1024, 49 agents (7
    # heads of 64), t 1025, batch 8, bf16 against the same module in fp32
    # (TF32 off), relative L2 <= MODEL_BF16_TOL
    torch.manual_seed(0)
    ag = AgentAttention(1024, 7, 64, agent_num=49).to(dev)
    xa = randn(8, 1025, 1024)
    c = counts()
    with torch.no_grad():
        ya16 = ag(xa.bfloat16())
        ya32 = ag(xa)
    ag_err = rel_l2(ya16, ya32)
    expect_delta(c, {}, "AgentAttention")
    print(f"[agent] AgentAttention b8 t1025 dim 1024 h7 d64 49 agents, bf16 "
          f"vs fp32: rel_l2 {ag_err:.3e} (tol {MODEL_BF16_TOL:g})",
          flush=True)
    gate(ya16.shape == (8, 1025, 1024) and ya16.dtype == torch.bfloat16
         and bool(torch.isfinite(ya16).all()) and ag_err <= MODEL_BF16_TOL,
         f"AgentAttention bf16 vs fp32: {ag_err}")
    del ag, xa, ya16, ya32
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 20 --
    # Parti serving at cfg/parti.yaml's widths (dim 1024, depth 12, 16 x 64
    # heads, the CLIP-L text tower, the vitvqgan_base tokenizer), bf16 over
    # fp32 parameters, seeded weights: 8 prompts, 1024 tokens a generate
    pa_depth = PARTI_YAML["model"]["depth"]
    pa_text = torch.as_tensor(text_ids, device=dev)
    pa_fixed = torch.randint(
        0, 8192, (8, 1024), device=dev,
        generator=torch.Generator(device=dev).manual_seed(20))
    parti = {}

    def parti_expected():
        """Launches of one generate: the CLIP tower's LayerNorms and
        context_norm, 1024 decode steps, the tokenizer's decode."""
        want = {k: v * 1024 for k, v in parti_step(pa_depth).items()}
        want["layernorm"] += CLIP_LAYERNORMS + 1
        for k, v in VQ_DECODE.items():
            want[k] = want.get(k, 0) + v
        return want

    def parti_teacher_forced(model, n=16):
        """The teacher-forced causal forward over the fixed grid (kernel 1
        causal on the card in bf16): logits of the first n positions."""
        with torch.inference_mode():
            ctx = model.prepare_context(pa_text)
            x = model.init_norm(model._embed_prefix(pa_fixed[:, :-1]))
            x = model.transformer_decoder(x, ctx, causal=True)
            return model.to_logits(model.final_norm(x)[:, :n]).float()

    def parti_cached(model, n=16):
        """The cached decode's logits of the first n steps, fed the fixed
        grid's tokens."""
        with torch.inference_mode():
            ctx = model.prepare_context(pa_text)
            cache, tok = model.new_cache(8), model.start_embed(8)
            out = []
            for i in range(n):
                out.append(model.decode_step(tok, ctx, cache)[:, -1].float())
                tok = model.embed_token(pa_fixed[:, i:i + 1], i)
            return torch.stack(out, 1)

    def parti_gates(model, label, tol):
        """Cached decode against the teacher-forced forward (all kernels)
        and cached decode, kernels against plain."""
        model.use_kernels(True)
        tf_k, cd_k = parti_teacher_forced(model), parti_cached(model)
        model.use_kernels(False)
        cd_p = parti_cached(model)
        model.use_kernels(True)
        errs = dict(cached_vs_teacher_forced=rel_l2(cd_k, tf_k),
                    cached_kernels_vs_plain=rel_l2(cd_k, cd_p))
        print(f"[parti] {label}: the first 16 decode steps' logits, cached "
              f"decode vs the teacher-forced causal forward rel_l2 "
              f"{errs['cached_vs_teacher_forced']:.3e}, cached decode "
              f"kernels vs plain {errs['cached_kernels_vs_plain']:.3e} (tol "
              f"{tol:g} each)", flush=True)
        gate(all(bool(torch.isfinite(t).all()) for t in (tf_k, cd_k, cd_p))
             and max(errs.values()) <= tol, f"parti {label}: {errs}")
        return errs

    t0 = time.perf_counter()
    pm = build_model(parti_config("bf16"), device=dev).eval()
    parti["build_s"] = time.perf_counter() - t0
    print(f"[parti] build_model(cfg/parti.yaml, bf16) {parti['build_s']:.1f}"
          f" s, {sum(p.numel() for p in pm.parameters()) / 1e6:.1f} M "
          f"parameters; launches per generate {parti_expected()} (per step "
          f"{parti_step(pa_depth)})", flush=True)
    pa_svc = parti_service(pm, approx_topk=True)
    parti["first_steps_bf16"] = parti_gates(pm, "bf16", MODEL_BF16_TOL)
    # kernel 3 a decode step, by shape: (8, 1, 1024) for init_norm, norm1-3
    # and final_norm, (8, 1, 2730) for the FFN's gamma LayerNorm
    ln_shapes, real_ln = {}, ln_mod._layernorm_kernel

    def tally(x, *rest):
        ln_shapes[tuple(x.shape)] = ln_shapes.get(tuple(x.shape), 0) + 1
        return real_ln(x, *rest)

    with torch.inference_mode():
        ctx0, cache0 = pm.prepare_context(pa_text), pm.new_cache(8)
        ln_mod._layernorm_kernel = tally
        pm.decode_step(pm.start_embed(8), ctx0, cache0)
        ln_mod._layernorm_kernel = real_ln
    want_shapes = {(8, 1, 1024): 2 + 3 * pa_depth, (8, 1, 2730): pa_depth}
    parti["layernorm_per_step"] = {str(k): v for k, v in ln_shapes.items()}
    print(f"[parti] kernel 3 launches a decode step: {ln_shapes} (expected "
          f"{want_shapes}, {sum(want_shapes.values())} in all)", flush=True)
    gate(ln_shapes == want_shapes
         and sum(want_shapes.values()) == parti_step(pa_depth)["layernorm"],
         f"parti kernel 3 a step: {ln_shapes}")
    del ctx0, cache0

    def parti_greedy(model, gs):
        """Greedy ids and images of one generate."""
        seen, real = [], model.vq.decode_indices
        model.vq.decode_indices = lambda idx: seen.append(idx) or real(idx)
        out = parti_generate(model, pa_text, temperature=0.0,
                             guidance_scale=gs)
        del model.vq.decode_indices
        return seen[0], out

    for gs in (0.0, 3.0):
        c = counts()
        ids_g, out_g = parti_greedy(pm, gs)
        expect_delta(c, parti_expected(), f"parti greedy generate gs {gs}")
        finite = bool(torch.isfinite(out_g).all())
        print(f"[parti] greedy generate, guidance_scale {gs:g}: images "
              f"{tuple(out_g.shape)}, finite {finite}, distinct ids "
              f"{int(ids_g.unique().numel())}", flush=True)
        gate(out_g.shape == (8, 3, 256, 256) and finite,
             f"parti greedy gs {gs}: {tuple(out_g.shape)}, finite {finite}")
        if gs == 0.0:
            ids_k = ids_g
    pm.use_kernels(False)
    ids_p, _ = parti_greedy(pm, 0.0)
    pm.use_kernels(True)
    parti["greedy_id_agreement"] = float((ids_k == ids_p).float().mean())
    first = (ids_k != ids_p).float().argmax(1)
    print(f"[parti] whole greedy generate, kernels vs plain: id agreement "
          f"{parti['greedy_id_agreement']:.4f} (reported; first differing "
          f"step per row {first.tolist()})", flush=True)
    del out_g, ids_g, ids_k, ids_p

    def parti_generate_s():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = pa_svc(text_ids, list(range(8)))
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    # the serving path: two service generates, the first with its launches
    # counted from 0 and its images checked; both timed (three until the
    # phases of the CNN tokenizer and the Transformer came; a generate is
    # 20-29 s of host time)
    torch.cuda.reset_peak_memory_stats()
    c = zero_counts()
    first_s, pa_out = parti_generate_s()
    expect_delta(c, parti_expected(), "parti_service generate")
    parti_launches = counts()
    gate(pa_out.shape == (8, 3, 256, 256)
         and bool(torch.isfinite(pa_out).all()),
         f"parti_service: {tuple(pa_out.shape)}")
    parti["generate_s"] = [first_s, parti_generate_s()[0]]
    parti["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    pa_s = float(np.median(parti["generate_s"]))
    parti["ms_per_token"], parti["images_per_s"] = pa_s / 1024 * 1e3, 8 / pa_s
    print(f"[parti] parti_service generate, batch 8, 1024 tokens, bf16, "
          f"approx top-k, temperature 1: {pa_s * 1e3:.1f} ms "
          f"({parti['ms_per_token']:.3f} ms a token, "
          f"{parti['images_per_s']:.4f} images/s; median of 2, "
          f"{min(parti['generate_s']) * 1e3:.1f}-"
          f"{max(parti['generate_s']) * 1e3:.1f} ms); peak memory "
          f"{parti['peak_gib']:.3f} GiB | {smi}", flush=True)

    def parti_steps(n=16):
        with torch.inference_mode():
            ctx = pm.prepare_context(pa_text)
            cache, tok = pm.new_cache(8), pm.start_embed(8)
            for i in range(n):
                last = pm.decode_step(tok, ctx, cache)[:, -1]
                nxt = torch.argmax(last, dim=-1)
                tok = pm.embed_token(nxt[:, None], i)

    parti["profile"] = profile(torch, parti_steps, parti_steps,
                               "16 Parti decode steps (batch 8, bf16, the "
                               "context included)")
    del pm, pa_svc, pa_out
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for the fp32 Parti check")
    pm32 = build_model(parti_config("no"), device=dev).eval()
    parti["first_steps_fp32"] = parti_gates(pm32, "fp32 (TF32 off)", 1e-4)
    del pm32
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 21, 22 --
    # Parti's and Muse's training: one full-width decoder layer, its final
    # norm and the head loss, kernels against plain (bf16, every gradient);
    # the trainer on the shipped config (GEN_TRAIN_OVERRIDES), 4 micro-steps
    # with exact launches each; then one fp32 (TF32 off) micro-step's loss
    # and trainable gradients of the whole model, kernels against plain
    def set_kernels(modules, kernels):
        for m in modules:
            if hasattr(m, "kernels"):
                m.kernels = kernels

    def layer_gate(label, layer, norm, bias, context, causal, targets,
                   want, vocab=8192):
        """The length is the targets' (8, t); ``vocab`` the head's (1024
        over the CNN tokenizer)."""
        init = torch.Generator().manual_seed(3)
        for m in layer.modules():
            if isinstance(m, torch.nn.Linear):
                lecun_normal_(m.weight, init)
        layer, norm = layer.to(dev), norm.to(dev)
        t_len = targets.shape[1]
        head_w = torch.nn.init.trunc_normal_(
            torch.empty(vocab, 1024), 0.0, 0.02, -0.04, 0.04,
            generator=init).to(dev).requires_grad_(True)
        head_b = (randn(vocab, scale=0.02).requires_grad_(True) if bias
                  else None)
        xl = randn(8, t_len, 1024, dtype=torch.bfloat16)
        params = [*layer.parameters(), *norm.parameters(), head_w,
                  *([head_b] if bias else [])]
        names = (["loss", "dx"]
                 + [f"layer.{k}" for k, _ in layer.named_parameters()]
                 + [f"final_norm.{k}" for k, _ in norm.named_parameters()]
                 + ["head"] + (["head_bias"] if bias else []))

        def grads(kernels):
            set_kernels((*layer.modules(), norm), kernels)
            xr = xl.clone().requires_grad_(True)
            h = norm(layer(xr, context, causal=causal))
            loss = (fused_head_xent if kernels else _head_xent_loss_reference)(
                h, head_w, targets, bias=head_b)
            return [loss.detach(),
                    *torch.autograd.grad(loss, [xr, *params])]

        c = counts()
        got = grads(True)
        expect_delta(c, want, f"{label} layer + head forward + backward")
        errs = {k: rel_l2(a, b) for k, a, b in zip(names, got, grads(False))}
        worst = max(errs, key=errs.get)
        mode = "causal" if causal else "bidirectional"
        head = "biased head" if bias else "head"
        print(f"[{label}] one DecoderLayer ({mode}) + final_norm + {head} "
              f"loss, b8 t{t_len} d1024 V {vocab}, bf16 over fp32 params, "
              f"kernels vs "
              f"plain: loss {errs['loss']:.3e}, dx {errs['dx']:.3e}, worst "
              f"{worst} {errs[worst]:.3e} (tol {MODEL_BF16_TOL:g}), {len(errs) - 1} "
              f"gradients", flush=True)
        gate(all(e <= MODEL_BF16_TOL for e in errs.values()),
             f"{label} layer gradients: {errs}")
        return errs

    def run_trainer(label, yaml, per_step):
        # beside phase 9's outputs
        tcfg_ = gen_train_config(yaml, os.path.join(
            os.path.dirname(tcfg.experiment.output_dir),
            f"chip_smoke_{label}"))
        tr = build_trainer(tcfg_, build_model(tcfg_, device=dev),
                           build_loader(tcfg_), dev)
        step_fn, steps = tr.train_step, []
        tr.train_step = traced(step_fn, steps, ("loss",))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        tr.train()
        torch.cuda.synchronize()
        path = counts()
        tr.train_step = step_fn
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for i, st in enumerate(steps):
            print(f"[{label}] micro-step {i}: {st['ms']:.2f} ms, loss "
                  f"{st['loss']:.4f}", flush=True)
            gate(st["launches"] == {k: per_step.get(k, 0)
                                    for k in st["launches"]}
                 and np.isfinite(st["loss"]),
                 f"{label} micro-step {i}: launches {st['launches']}, "
                 f"expected {per_step}, loss {st['loss']}")
        gate(len(steps) == 4 and tr.opt.count == 1,
             f"{label}: {len(steps)} micro-steps, {tr.opt.count} optimizer "
             f"steps")
        ms = float(np.mean([st["ms"] for st in steps[2:]]))
        row = dict(steps=steps, step_ms=ms,
                   images_per_s=tr.batch_size / ms * 1e3, peak_gib=peak)
        print(f"[{label}] 4 micro-steps, 1 optimizer step, launches a "
              f"micro-step {per_step}; micro-step {ms:.2f} ms (mean of steps"
              f" 2-3; steps 0-1 {steps[0]['ms']:.2f}, {steps[1]['ms']:.2f} "
              f"ms), {row['images_per_s']:.2f} images/s, peak memory "
              f"{peak:.3f} GiB | {smi}", flush=True)
        batch = next(iter(tr.batches()))
        row["profile"] = profile(
            torch, lambda: tr.train_step(batch), lambda: tr.train_step(batch),
            f"1 {label} micro-step")
        del tr, batch
        torch.cuda.empty_cache()
        return row, path

    def fp32_gate(label, model, loss_of):
        """One micro-step's loss and trainable gradients in fp32, kernels
        against plain."""
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            raise AssertionError(f"TF32 must be off for the fp32 {label} "
                                 f"check")
        params = [p for k, p in model.named_parameters()
                  if not k.startswith(("vq.", "text_encoder."))]
        out = {}
        for kernels in (True, False):
            model.use_kernels(kernels)
            loss = loss_of(model)
            out[kernels] = (loss.detach().double(),
                            torch.autograd.grad(loss, params))
        model.use_kernels(True)
        (lk, gk), (lp, gp) = out[True], out[False]
        loss_err = float((lk - lp).abs() / lp.abs())
        grad_errs = [rel_l2(a, b) for a, b in zip(gk, gp)]
        print(f"[{label}] fp32 whole model (TF32 off), kernels vs plain: "
              f"loss {float(lk):.6f} vs {float(lp):.6f}, relative "
              f"{loss_err:.3e} (tol 1e-5); worst of {len(grad_errs)} "
              f"gradients rel_l2 {max(grad_errs):.3e} (tol 1e-4)", flush=True)
        gate(loss_err <= 1e-5 and max(grad_errs) <= 1e-4,
             f"{label} fp32 step: loss {loss_err}, gradients "
             f"{max(grad_errs)}")
        return dict(loss_rel=loss_err, grad_rel_l2=grad_errs)

    tgen = torch.Generator(device=dev).manual_seed(21)
    fp32_imgs = torch.rand(8, 3, 256, 256, generator=tgen, device=dev)
    targets = torch.randint(0, 8192, (8, 1024), generator=tgen, device=dev)
    parti_train = dict(layer_rel_l2=layer_gate(
        "parti_train", DecoderLayer(1024, 16, 64, 4, context_dim=768),
        LayerNorm(1024), True, randn(8, 77, 768, dtype=torch.bfloat16), True,
        targets, {"flash_attention_bthd_kv": 1, "flash_attention_bwd_kv": 1,
                  "layernorm": 5, "head_xent": 1, "head_xent_bwd": 1}))
    row, parti_train_launches = run_trainer(
        "parti_train", PARTI_YAML, parti_train_step(pa_depth))
    parti_train.update(row)
    m32 = build_model(parti_config("no"), device=dev)
    grid = m32.encode_to_indices(fp32_imgs)
    pe_keep = torch.rand(8, 1023, 1024, generator=tgen, device=dev) >= 0.1
    parti_train["fp32"] = fp32_gate(
        "parti_train", m32, lambda m: m.loss_from_indices(
            pa_text, grid, deterministic=False, pe_keep=pe_keep))
    del m32, grid, pe_keep
    torch.cuda.empty_cache()

    tgt_m = targets.clone()
    tgt_m[torch.rand(8, 1024, generator=tgen, device=dev) < 0.36] = -1
    muse_train = dict(layer_rel_l2=layer_gate(
        "muse_train", DecoderLayer(1024, 16, 64, 6), GammaLayerNorm(1024),
        False, randn(8, 77, 1024, dtype=torch.bfloat16), False, tgt_m,
        {"flash_attention_bthd_kv": 1, "flash_attention_bwd_kv": 1,
         "layernorm": 4, "ffn": 1, "ffn_bwd": 1, "head_xent": 1,
         "head_xent_bwd": 1}))
    row, muse_train_launches = run_trainer(
        "muse_train", MUSE_YAML, muse_train_step(mu_depth))
    muse_train.update(row)
    m32 = build_model(muse_config("no", None), device=dev)
    grid = m32.encode_to_indices(fp32_imgs)
    draws = ((torch.rand(8, generator=tgen, device=dev),
              torch.rand(8, 1024, generator=tgen, device=dev)),
             torch.rand(8, generator=tgen, device=dev))
    muse_train["fp32"] = fp32_gate(
        "muse_train", m32, lambda m: m.loss_from_indices(
            pa_text, grid, mask_draws=draws[0], cond_draws=draws[1]))
    del m32, grid, fp32_imgs
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 23 --
    # the CNN tokenizer (code width 256, 1024 codes: the model of
    # inference/vqgan.py and muse_vqgan) on the serving path: build_model on
    # the vqgan config (cfg/vitvqgan.yaml's settings, bf16 compute over fp32
    # weights), seeded, batch 8, 256 px. Kernel 4 is its one kernel (width
    # 256: the first design); the convolutions, GroupNorms and the NonLocal
    # attention are PyTorch, so the plain path differs in the codebook only
    torch.backends.cudnn.allow_tf32 = False
    out_root = os.path.dirname(tcfg.experiment.output_dir)
    vq_out = os.path.join(out_root, "chip_smoke_vqgan")
    t0 = time.perf_counter()
    vqm = build_model(vqgan_config("bf16", vq_out)).reset_parameters(
        torch.Generator().manual_seed(42)).to(dev).eval()
    vqgan = dict(build_s=time.perf_counter() - t0)
    vq_recon, vq_encode = vq_recon_service(vqm), vq_encode_service(vqm)
    torch.cuda.synchronize()
    c = zero_counts()
    vrecs = []
    for r in requests:
        vrecs.append(vq_recon(r, None))
        c = expect_delta(c, CNN_ENCODE, "vqgan recon request")
    vidx = vq_encode(requests[0], None)
    c = expect_delta(c, CNN_ENCODE, "vqgan encode request")
    torch.cuda.synchronize()
    vqgan_launches = counts()
    gate(all(bool(torch.isfinite(t).all()) for t in vrecs)
         and vrecs[0].shape == (8, 3, 256, 256) and vidx.shape == (8, 256),
         f"vqgan outputs {tuple(vrecs[0].shape)}, {tuple(vidx.shape)}")
    with torch.inference_mode():
        z0 = vqm._encode_features(torch.as_tensor(requests[0], device=dev))
        vqm.use_kernels(False)
        vrec_p = vq_recon(requests[0], None)
        vidx_p = vq_encode(requests[0], None)
        vqm.use_kernels(True)
        vdist = plain_distances(
            l2_normalize(z0.float()).reshape(-1, 256).to(torch.bfloat16),
            l2_normalize(vqm.codebook.embedding.weight.float()).to(
                torch.bfloat16))
    agree, worst_gap, excess = index_report(vidx.reshape(-1),
                                            vidx_p.reshape(-1), vdist)
    vqgan.update(index_agreement_bf16=agree,
                 recon_rel_l2_bf16=rel_l2(vrecs[0], vrec_p))
    print(f"[vqgan] build_model(vqgan: cfg/vitvqgan.yaml + {VQGAN_OVERRIDES},"
          f" bf16) {vqgan['build_s']:.1f} s, "
          f"{sum(p.numel() for p in vqm.parameters()) / 1e6:.1f} M "
          f"parameters; launches over 3 recon + 1 encode requests "
          f"{vqgan_launches}; kernels vs plain (bf16): index agreement "
          f"{agree:.6f}, largest gap at a disagreement {worst_gap:.3e} (tol "
          f"1e-5), chosen-distance excess {excess:.3e} (tol 1e-5), recon "
          f"rel_l2 {vqgan['recon_rel_l2_bf16']:.3e} (tol {MODEL_BF16_TOL:g})",
          flush=True)
    gate(worst_gap <= 1e-5 and excess <= 1e-5
         and vqgan["recon_rel_l2_bf16"] <= MODEL_BF16_TOL,
         f"vqgan kernels vs plain: {vqgan}")

    vqgan.update(recon_imgs_per_s=imgs_per_s(vq_recon),
                 encode_imgs_per_s=imgs_per_s(vq_encode))
    print(f"[vqgan] batch 8, 256 px, bf16, 10 requests: recon "
          f"{vqgan['recon_imgs_per_s']:.2f} imgs/s, encode "
          f"{vqgan['encode_imgs_per_s']:.2f} imgs/s | {smi}", flush=True)
    vqgan["recon_profile"] = profile(
        torch, lambda: [vq_recon(r, None) for r in requests],
        lambda: vq_recon(requests[0], None), "3 vqgan recon requests")
    vqgan["encode_profile"] = profile(
        torch, lambda: [vq_encode(r, None) for r in requests],
        lambda: vq_encode(requests[0], None), "3 vqgan encode requests")
    del vqm, vrecs, vrec_p, z0, vdist

    # the fp32 golden encode (the shipped mixed_precision "no"), TF32 off:
    # the index criterion of phase 6 at width 256
    gate(not (torch.backends.cuda.matmul.allow_tf32
              or torch.backends.cudnn.allow_tf32),
         "TF32 must be off for the fp32 golden path")
    vq32 = build_model(vqgan_config("no", vq_out)).reset_parameters(
        torch.Generator().manual_seed(42)).to(dev).eval()
    with torch.inference_mode():
        x32 = torch.as_tensor(requests[1], device=dev)
        c = counts()
        idx_k = vq32.encode_imgs(x32).reshape(-1)
        expect_delta(c, CNN_ENCODE, "vqgan fp32 encode")
        vq32.use_kernels(False)
        z_p = vq32._encode_features(x32)
        idx_p = vq32.codebook.nearest(z_p).reshape(-1)
        vq32.use_kernels(True)
        dist = plain_distances(
            l2_normalize(z_p.float()).reshape(-1, 256),
            l2_normalize(vq32.codebook.embedding.weight.float()))
    agree, worst_gap, _ = index_report(idx_k, idx_p, dist)
    vqgan.update(golden_index_agreement=agree, golden_worst_gap=worst_gap)
    print(f"[vqgan] fp32 encode_imgs, TF32 off: index agreement {agree:.6f} "
          f"(tol >= 0.999), largest plain top-2 gap at a disagreement "
          f"{worst_gap:.3e} (tol 1e-4)", flush=True)
    gate(agree >= 0.999 and worst_gap <= 1e-4,
         "vqgan fp32 golden index criterion failed")
    del vq32, x32, z_p, dist
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 24 --
    # the CNN tokenizer's GAN training: VQGANTrainer.train() on the vqgan
    # config with TRAIN_OVERRIDES (as phase 7: synthetic data, 16 examples,
    # 2 epochs = 4 micro-steps of batch 8, 2 optimizer steps; PyTorch's
    # TF32 defaults for the convolutions)
    torch.backends.cudnn.allow_tf32 = True
    vcfg = vqgan_config("bf16", vq_out)
    vtr = build_trainer(vcfg, build_model(vcfg), build_loader(vcfg), dev)
    vstep_fn, vsteps = vtr.train_step, []
    vq_losses = ("d_loss", "gp", "codebook_loss", "g_loss", "per_loss",
                 "logit_laplace", "l2_loss")
    vtr.train_step = traced(vstep_fn, vsteps, vq_losses)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    vtr.train()
    torch.cuda.synchronize()
    vqgan_train_launches = counts()
    vtr.train_step = vstep_fn
    vqgan_train = dict(steps=vsteps,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    for i, st in enumerate(vsteps):
        losses = {k: st[k] for k in vq_losses}
        print(f"[vqgan_train] micro-step {i}: {st['ms']:.2f} ms, losses "
              + ", ".join(f"{k} {v:.4f}" for k, v in losses.items()),
              flush=True)
        gate(st["launches"] == {k: CNN_ENCODE.get(k, 0)
                                for k in st["launches"]}
             and all(np.isfinite(v) for v in losses.values()),
             f"vqgan_train micro-step {i}: launches {st['launches']}, "
             f"losses {losses}")
    gate(len(vsteps) == 4 and vtr.g_opt.count == 2,
         f"vqgan_train: {len(vsteps)} micro-steps, {vtr.g_opt.count} "
         f"optimizer steps")
    vqgan_train["step_ms"] = float(np.mean([st["ms"] for st in vsteps[2:]]))
    vqgan_train["imgs_per_s"] = vtr.batch_size / vqgan_train["step_ms"] * 1e3
    print(f"[vqgan_train] 4 micro-steps, 2 optimizer steps, launches a "
          f"micro-step {CNN_ENCODE}; micro-step {vqgan_train['step_ms']:.2f} "
          f"ms (mean of steps 2-3; steps 0-1 {vsteps[0]['ms']:.2f}, "
          f"{vsteps[1]['ms']:.2f} ms), {vqgan_train['imgs_per_s']:.2f} "
          f"imgs/s, peak memory {vqgan_train['peak_gib']:.3f} GiB | {smi}",
          flush=True)
    img = vtr.to_device(next(iter(vtr.train_dl))[0])
    vqgan_train["profile"] = profile(
        torch, lambda: [vstep_fn(img) for _ in range(2)],
        lambda: vstep_fn(img), "2 vqgan training micro-steps")
    del vtr, img
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 25 --
    # Muse over the CNN tokenizer: build_model on cfg_exp/muse_vqgan.yaml
    # (dim 1024, 22 layers of 16 x 64 heads, mult 6, CLIP-L; 256 tokens and
    # 1024 classes), seeded, bf16 compute over fp32 weights (the shipped
    # "no" in the fp32 check), quant none: muse_service on the 8 prompts,
    # 18 steps, guidance 3, approx top-k
    mv_depth = MUSE_VQGAN_YAML["model"]["decoder"]["depth"]
    t0 = time.perf_counter()
    mv = build_model(muse_vqgan_config("bf16"), device=dev).eval()
    muse_vqgan = dict(build_s=time.perf_counter() - t0)
    mv_svc = muse_service(mv, timesteps=18, approx_topk=True)
    mv_want = {k: v * 18 for k, v in muse_step(mv_depth, None, True).items()}
    mv_want["layernorm"] += CLIP_LAYERNORMS  # the CNN decode launches none
    torch.cuda.synchronize()
    c = zero_counts()
    out = mv_svc(text_ids, mu_seeds)
    torch.cuda.synchronize()
    expect_delta(c, mv_want, "muse_vqgan generate")
    muse_vqgan_launches = counts()
    gate(out.shape == (8, 3, 256, 256) and bool(torch.isfinite(out).all()),
         f"muse_vqgan: {tuple(out.shape)}")
    print(f"[muse_vqgan] build_model(cfg_exp/muse_vqgan.yaml, bf16) "
          f"{muse_vqgan['build_s']:.1f} s, "
          f"{sum(p.numel() for p in mv.parameters()) / 1e6:.1f} M "
          f"parameters; launches per generate {mv_want} (per step "
          f"{muse_step(mv_depth, None, True)})", flush=True)
    lg_k, picks_k = muse_first_step(mv, True)
    lg_p, picks_p = muse_first_step(mv, False)
    muse_vqgan.update(
        first_step_logits_rel_l2_bf16=rel_l2(lg_k, lg_p),
        first_step_pick_agreement_bf16=float(
            (picks_k[0] == picks_p[0]).float().mean()),
        nudged_rel_l2_bf16=rel_l2(muse_nudged(mv), lg_p))
    # the seeded model's own bf16 floor (the nudged plain path) lies at or
    # above the 2e-2 of phase 11's quant none, so the logits are held, as
    # the quant modes' are, to FLOOR_RATIO x that floor; fp32 and layer 0
    # below carry the tight gates
    lg_tol = FLOOR_RATIO * muse_vqgan["nudged_rel_l2_bf16"]
    print(f"[muse_vqgan] first decode step, bf16: logits rel_l2 "
          f"{muse_vqgan['first_step_logits_rel_l2_bf16']:.3e} (tol "
          f"{lg_tol:.3e} = 1.25 x nudged); plain path with 1 % of the "
          f"position rows nudged by about one bf16 ulp "
          f"{muse_vqgan['nudged_rel_l2_bf16']:.3e}; pick agreement "
          f"{muse_vqgan['first_step_pick_agreement_bf16']:.6f} (reported)",
          flush=True)
    gate(muse_vqgan["first_step_logits_rel_l2_bf16"] <= lg_tol,
         f"muse_vqgan bf16 first-step logits: {muse_vqgan}")
    upd = muse_layer0(mv)
    l0 = muse_vqgan["layer0_update_rel_l2_bf16"] = dict(
        kernels_vs_plain=rel_l2(upd["kernels"], upd["plain"]),
        kernels_vs_fp32=rel_l2(upd["kernels"], upd["fp32"]),
        plain_vs_fp32=rel_l2(upd["plain"], upd["fp32"]))
    print(f"[muse_vqgan] layer 0 update, bf16: kernels vs plain "
          f"{l0['kernels_vs_plain']:.3e} (tol {BF16_TOL:g}); against fp32 "
          f"kernels {l0['kernels_vs_fp32']:.3e}, plain "
          f"{l0['plain_vs_fp32']:.3e} (tol kernels <= {FLOOR_RATIO:g} x "
          f"plain)", flush=True)
    gate(l0["kernels_vs_plain"] <= BF16_TOL
         and l0["kernels_vs_fp32"] <= FLOOR_RATIO * l0["plain_vs_fp32"],
         f"muse_vqgan layer 0: {l0}")
    del upd

    muse_vqgan["generate_s"] = [muse_generate_s(mv_svc) for _ in range(3)]
    gen_s = float(np.median(muse_vqgan["generate_s"]))
    torch.cuda.reset_peak_memory_stats()
    muse_generate_s(mv_svc)
    muse_vqgan.update(peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                      ms_per_step=gen_s / 18 * 1e3, images_per_s=8 / gen_s)
    print(f"[muse_vqgan] generate, batch 8, 18 steps, bf16, approx: "
          f"{gen_s * 1e3:.2f} ms ({muse_vqgan['ms_per_step']:.3f} ms/step, "
          f"{muse_vqgan['images_per_s']:.3f} images/s; median of 3, "
          f"{min(muse_vqgan['generate_s']) * 1e3:.2f}-"
          f"{max(muse_vqgan['generate_s']) * 1e3:.2f} ms); peak memory "
          f"{muse_vqgan['peak_gib']:.3f} GiB | {smi}", flush=True)
    muse_vqgan["profile"] = profile(
        torch, lambda: mv_svc(text_ids, mu_seeds),
        lambda: mv_svc(text_ids, mu_seeds),
        "1 muse_vqgan generate (batch 8, 18 steps)")
    del mv, mv_svc, out
    torch.cuda.empty_cache()
    gate(not (torch.backends.cuda.matmul.allow_tf32
              or torch.backends.cudnn.allow_tf32),
         "TF32 must be off for the fp32 muse_vqgan check")
    m32 = build_model(muse_vqgan_config("no"), device=dev).eval()
    lg32_k, picks32_k = muse_first_step(m32, True)
    lg32_p, picks32_p = muse_first_step(m32, False)
    r16 = muse_vqgan["bf16_logits_vs_fp32"] = dict(
        kernels=rel_l2(lg_k, lg32_p), plain=rel_l2(lg_p, lg32_p))
    muse_vqgan["first_step_logits_rel_l2_fp32"] = rel_l2(lg32_k, lg32_p)
    print(f"[muse_vqgan] first decode step, fp32 (TF32 off): logits rel_l2 "
          f"{muse_vqgan['first_step_logits_rel_l2_fp32']:.3e} (tol 1e-4); "
          f"bf16 logits against them: kernels {r16['kernels']:.3e}, plain "
          f"{r16['plain']:.3e} (tol kernels <= {FLOOR_RATIO:g} x plain)",
          flush=True)
    gate(muse_vqgan["first_step_logits_rel_l2_fp32"] <= 1e-4
         and r16["kernels"] <= FLOOR_RATIO * r16["plain"],
         f"muse_vqgan fp32 first step: {muse_vqgan}")
    cond32 = [t.reshape(-1, 1024) for t in lg32_p.chunk(2)]
    cond32_k = [t.reshape(-1, 1024) for t in lg32_k.chunk(2)]
    epilogue_check("muse_vqgan fp32 first step", guided(*cond32),
                   philox_bits(seeds_dev, 256, 0, 1024), temp0, picks32_k,
                   picks32_p, 1e-4, relative=False,
                   x32_got=guided(*cond32_k), k=k_1024)
    del m32, lg32_k, lg32_p, lg_k, lg_p, cond32, cond32_k
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 26 --
    # Muse's training over the CNN tokenizer: the layer gate at 256 tokens
    # and vocab 1024, the trainer with GEN_TRAIN_OVERRIDES (batch 8,
    # accumulation 4, bf16: the shipped config has accumulation 16, fp32),
    # then the fp32 whole-model step (TF32 off)
    tgen = torch.Generator(device=dev).manual_seed(26)
    tgt_v = torch.randint(0, 1024, (8, 256), generator=tgen, device=dev)
    tgt_v[torch.rand(8, 256, generator=tgen, device=dev) < 0.36] = -1
    muse_vqgan_train = dict(layer_rel_l2=layer_gate(
        "muse_vqgan_train", DecoderLayer(1024, 16, 64, 6),
        GammaLayerNorm(1024), False,
        randn(8, 77, 1024, dtype=torch.bfloat16), False, tgt_v,
        {"flash_attention_bthd_kv": 1, "flash_attention_bwd_kv": 1,
         "layernorm": 4, "ffn": 1, "ffn_bwd": 1, "head_xent": 1,
         "head_xent_bwd": 1}, vocab=1024))
    row, muse_vqgan_train_launches = run_trainer(
        "muse_vqgan_train", MUSE_VQGAN_YAML,
        muse_train_step(mv_depth, CNN_ENCODE))
    muse_vqgan_train.update(row)
    m32 = build_model(muse_vqgan_config("no"), device=dev)
    grid = m32.encode_to_indices(
        torch.rand(8, 3, 256, 256, generator=tgen, device=dev))
    draws = ((torch.rand(8, generator=tgen, device=dev),
              torch.rand(8, 256, generator=tgen, device=dev)),
             torch.rand(8, generator=tgen, device=dev))
    muse_vqgan_train["fp32"] = fp32_gate(
        "muse_vqgan_train", m32, lambda m: m.loss_from_indices(
            pa_text, grid, mask_draws=draws[0], cond_draws=draws[1]))
    del m32, grid
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 27 --
    # the seq2seq Transformer: build_model + build_trainer on
    # cfg/transformer.yaml (dim 512, 16 x 64 heads, 6 + 6 layers, vocab
    # 1000, batch 64, 20 source tokens, bf16) with TRANSFORMER_OVERRIDES (4
    # micro-steps), exact launches each; one generate at max_len 21 (the
    # trainer's on_sample decode); an fp32 step, kernels vs plain
    tf_cfg = transformer_config("bf16", os.path.join(
        out_root, "chip_smoke_transformer"))
    tf_m = tf_cfg.model
    tf_step = transformer_step(tf_m.enc_depth, tf_m.dec_depth)
    ttr = build_trainer(tf_cfg, build_model(tf_cfg, device=dev),
                        build_loader(tf_cfg), dev)
    tstep_fn, tsteps = ttr.train_step, []
    ttr.train_step = traced(tstep_fn, tsteps, ("loss", "acc"))
    torch.cuda.synchronize()
    tf_held = torch.cuda.memory_allocated() / 2 ** 30  # by earlier phases
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    ttr.train()
    ttr.train_step = tstep_fn
    # the trainer's sample decode (on_sample's generate) on the first
    # validation batch, padded to the batch
    src_val, tgt_val = next(iter(ttr.val_dl))
    src_d = ttr.ids(ttr.pad_batch(np.asarray(src_val))[0])
    max_len = int(np.asarray(tgt_val).shape[1])
    tf_gen = transformer_generate(tf_m.enc_depth, tf_m.dec_depth, max_len)
    ttr.model.eval()
    torch.cuda.synchronize()
    c = counts()
    t = time.perf_counter()
    toks_k = ttr.model.generate(src_d, max_len, generator=torch.Generator(
        device=dev).manual_seed(7))
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t) * 1e3
    expect_delta(c, tf_gen, "transformer generate")
    transformer_launches = counts()
    transformer = dict(steps=tsteps, held_gib=tf_held,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    ttr.model.use_kernels(False)
    toks_p = ttr.model.generate(src_d, max_len, generator=torch.Generator(
        device=dev).manual_seed(7))
    ttr.model.use_kernels(True)
    ttr.model.train()
    gate(toks_k.shape == (64, max_len + 1) and bool((toks_k[:, 0] == 1).all()),
         f"transformer generate: {tuple(toks_k.shape)}")
    for i, st in enumerate(tsteps):
        print(f"[transformer] micro-step {i}: {st['ms']:.2f} ms, loss "
              f"{st['loss']:.4f}, token accuracy {st['acc']:.4f}", flush=True)
        gate(st["launches"] == {k: tf_step.get(k, 0) for k in st["launches"]}
             and np.isfinite(st["loss"]),
             f"transformer micro-step {i}: launches {st['launches']}, "
             f"expected {tf_step}, loss {st['loss']}")
    gate(len(tsteps) == 4 and ttr.opt.count == 4,
         f"transformer: {len(tsteps)} micro-steps, {ttr.opt.count} "
         f"optimizer steps")
    tgt_tokens = ttr.batch_size * (TRANSFORMER_YAML["dataset"]["params"][
        "seq_len"] + 1)
    transformer.update(
        step_ms=float(np.mean([st["ms"] for st in tsteps[2:]])),
        generate_ms=gen_ms,
        generate_id_agreement=float((toks_k == toks_p).float().mean()))
    transformer["tokens_per_s"] = tgt_tokens / transformer["step_ms"] * 1e3
    print(f"[transformer] 4 micro-steps, launches a micro-step {tf_step}; "
          f"micro-step {transformer['step_ms']:.2f} ms (mean of steps 2-3; "
          f"steps 0-1 {tsteps[0]['ms']:.2f}, {tsteps[1]['ms']:.2f} ms), "
          f"{transformer['tokens_per_s']:.1f} target tokens/s ({tgt_tokens} "
          f"a micro-step), peak memory {transformer['peak_gib']:.3f} GiB "
          f"({tf_held:.3f} GiB of it held by earlier phases); "
          f"generate, batch 64, max_len {max_len}: {gen_ms:.2f} ms, "
          f"launches {tf_gen}, kernels vs plain id agreement "
          f"{transformer['generate_id_agreement']:.4f} (reported) | {smi}",
          flush=True)
    tb = ttr.batch(*next(iter(ttr.train_dl)))
    transformer["profile"] = profile(
        torch, lambda: [tstep_fn(*tb) for _ in range(2)],
        lambda: tstep_fn(*tb), "2 transformer micro-steps", host_rows=15)
    # fp32 (TF32 off), kernels vs plain: the same weights, batch and
    # dropout draws (one generator seed on both paths)
    gate(not (torch.backends.cuda.matmul.allow_tf32
              or torch.backends.cudnn.allow_tf32),
         "TF32 must be off for the fp32 transformer check")
    tm32 = build_model(transformer_config("no", tf_cfg.experiment.output_dir),
                       device=dev)
    t_params = list(tm32.parameters())
    tf_out = {}
    for kernels in (True, False):
        tm32.use_kernels(kernels)
        drop = torch.Generator(device=dev).manual_seed(5)
        loss, _ = ce_and_acc(tm32(tb[0], tb[1], deterministic=False,
                                  generator=drop), tb[2])
        tf_out[kernels] = (loss.detach().double(),
                           torch.autograd.grad(loss, t_params))
    (lk, gk), (lp, gp) = tf_out[True], tf_out[False]
    transformer.update(fp32_loss_rel=float((lk - lp).abs() / lp.abs()),
                       fp32_grad_rel_l2=[rel_l2(a, b) for a, b in zip(gk, gp)])
    print(f"[transformer] fp32 step (TF32 off), kernels vs plain: loss "
          f"{float(lk):.6f} vs {float(lp):.6f}, relative "
          f"{transformer['fp32_loss_rel']:.3e} (tol 1e-5); worst of "
          f"{len(gk)} gradients rel_l2 "
          f"{max(transformer['fp32_grad_rel_l2']):.3e} (tol 1e-4)",
          flush=True)
    gate(transformer["fp32_loss_rel"] <= 1e-5
         and max(transformer["fp32_grad_rel_l2"]) <= 1e-4,
         f"transformer fp32 step: {transformer['fp32_loss_rel']}, "
         f"{max(transformer['fp32_grad_rel_l2'])}")
    del ttr, tm32, tb, tf_out, gk, gp
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 28 --
    sources = {
        "flash_attention_bthd_kv": ("flash_attention.cu",
                                    "attention_models_tpu/ops/flash_attention.py:217"),
        "ln_mlp": ("ln_mlp.cu", "attention_models_tpu/ops/ffn.py:542"),
        "layernorm": ("layernorm.cu", "attention_models_tpu/ops/layernorm.py:22"),
        "nearest_codes": ("codebook.cu", "attention_models_tpu/ops/codebook.py:33"),
        "flash_attention_bwd_kv": ("flash_attention_bwd.cu",
                                   "attention_models_tpu/ops/flash_attention.py:498"),
        "ln_mlp_bwd": ("ln_mlp_bwd.cu", "attention_models_tpu/ops/ffn.py:652"),
        "ffn": ("ffn.cu", "attention_models_tpu/ops/ffn.py:56"),
        "sample_epilogue": ("sampling.cu", "attention_models_tpu/ops/sampling.py:143"),
        "ffn_bwd": ("ffn_bwd.cu", "attention_models_tpu/ops/ffn.py:171"),
        "head_xent": ("xent.cu", "attention_models_tpu/ops/xent.py:42"),
        "head_xent_bwd": ("xent.cu", "attention_models_tpu/ops/xent.py:69"),
        "ffn_q8": ("quant.cu", "attention_models_tpu/ops/quant.py:90"),
        "ffn_q8wide": ("quant.cu", "attention_models_tpu/ops/quant.py:221"),
        "ln_mlp_q8": ("quant.cu", "attention_models_tpu/ops/quant.py:339"),
        "mlp": ("mlp.cu", "attention_models_tpu/ops/ffn.py:331"),
        "mlp_bwd": ("mlp_bwd.cu", "attention_models_tpu/ops/ffn.py:414"),
        "flash_attention_bthd": ("flash_attention.cu",
                                 "attention_models_tpu/ops/flash_attention.py:167"),
        "flash_attention_bwd_bthd": ("flash_attention_bwd.cu",
                                     "attention_models_tpu/ops/flash_attention.py:452"),
        "flash_forward": ("flash_attention.cu",
                          "attention_models_tpu/ops/flash_attention.py:46"),
        "flash_bwd_dkv": ("flash_attention_bwd.cu",
                          "attention_models_tpu/ops/flash_attention.py:341"),
        "flash_bwd_dq": ("flash_attention_bwd.cu",
                         "attention_models_tpu/ops/flash_attention.py:629"),
    }
    path_launches = {"serving": serving_launches, "training": launches,
                     "maskgit": maskgit_launches,
                     "maskgit_train": mtrain_launches, "muse": muse_launches,
                     "recon_int8": recon_int8_launches, "vit": vit_launches,
                     "longcontext": longcontext_launches,
                     "ring": ring_launches, "flash_bthd": bthd_launches,
                     "vit_moe": moe_launches,
                     "switchhead": switchhead_launches,
                     "parti": parti_launches,
                     "parti_train": parti_train_launches,
                     "muse_train": muse_train_launches,
                     "vqgan": vqgan_launches,
                     "vqgan_train": vqgan_train_launches,
                     "muse_vqgan": muse_vqgan_launches,
                     "muse_vqgan_train": muse_vqgan_train_launches,
                     "transformer": transformer_launches}
    kernels = []
    for k, (src, replaces) in sources.items():
        v = (next((v for v in variants if v["kernel"] == k and v["main"]), None)
             or next(v for v in variants if v["kernel"] == k
                     and v["dtype"] == "bfloat16"))
        per_path = {f"launches_{p}": n[k] for p, n in path_launches.items()}
        row = dict(
            name=k, route="cuda", source=f"attention_models_torch/csrc/{src}",
            replaces=replaces, launches=sum(per_path.values()),
            max_abs_err=v["max_abs_err"], ms=v["ms"], plain_ms=v["plain_ms"],
            bound_ms=v["bound_ms"], bound_by=v["bound_by"],
            library_ms=v["library_ms"], **per_path)
        if row["launches"] == 0:
            raise AssertionError(f"{k} never launched on a driven path")
        kernels.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=name, nvidia_smi=smi, variants=variants,
                           kernels=kernels, path_launches=path_launches,
                           block_grad_rel_l2=blk_errs,
                           recon_imgs_per_s=kern_ips,
                           plain_recon_imgs_per_s=plain_ips,
                           recon_imgs_per_s_wrapper_ab=wrapper_ab,
                           golden_index_agreement=agree,
                           profile=profile_rows, train_steps=steps,
                           train_step_ms=step_ms, train_imgs_per_s=train_ips,
                           train_peak_gib=peak_gib,
                           train_profile=train_profile,
                           maskgit=dict(
                               first_step_logits_rel_l2_bf16=lg_err,
                               first_step_logits_rel_l2_fp32=lg32_err,
                               bf16_logits_vs_fp32=dict(kernels=lg_k32,
                                                        plain=lg_p32),
                               layer0_update_rel_l2_bf16=dict(
                                   kernels_vs_plain=layer_err,
                                   kernels_vs_fp32=layer_k32,
                                   plain_vs_fp32=layer_floor),
                               nudged_embedding_rel_l2_bf16=nudge_err,
                               generate_id_agreement=id_agree,
                               generate_s=gen_times, ms_per_step=mg_ms_step,
                               images_per_s=mg_ips,
                               plain_generate_s=plain_gen_s,
                               peak_gib=mg_peak_gib,
                               profile=mg_profile),
                           maskgit_layer_grad_rel_l2=mlayer_errs,
                           maskgit_train=dict(
                               steps=msteps, step_ms=mtrain_ms,
                               images_per_s=mtrain_ips,
                               peak_gib=mtrain_peak,
                               profile=mtrain_profile,
                               fp32_loss_rel=loss32_err,
                               fp32_grad_rel_l2=grad32_errs,
                               bf16_vs_fp32=ratio,
                               fp32_step_ms=fp32_step_ms,
                               fp32_launches=fp32_launches,
                               fp32_profile=fp32_profile),
                           muse=muse,
                           recon_int8=dict(imgs_per_s=q_ips,
                                           index_agreement=q_agree),
                           vit=dict(
                               logits_rel_l2_bf16=vit_err,
                               bf16_logits_vs_fp32=dict(kernels=vit_k32,
                                                        plain=vit_p32),
                               eval_imgs_per_s=vit_ips,
                               plain_eval_imgs_per_s=vit_plain_ips,
                               eval_profile=eval_profile,
                               train_dropout_0_1=vit_train_drop,
                               train_dropout_0=vit_train_nodrop,
                               train_profile=vit_train_profile,
                               fp32_loss_rel=vit32_loss,
                               fp32_grad_rel_l2=vit32_grads),
                           vit_moe=dict(
                               logits_rel_l2_bf16=moe_err,
                               logits_rel_l2_bf16_free_routing=moe_free_err,
                               routing_decisions_differing=moe_flips,
                               bf16_logits_vs_fp32=dict(kernels=moe_k32,
                                                        plain=moe_p32),
                               bf16_logits_vs_fp32_free_routing=moe_free32,
                               routing_decisions_differing_from_fp32=(
                                   moe_flips32),
                               dropped_pairs=moe_drops,
                               eval_imgs_per_s=moe_ips,
                               plain_eval_imgs_per_s=moe_plain_ips,
                               eval_peak_gib=moe_eval_peak,
                               eval_held_gib=moe_eval_held,
                               eval_profile=moe_eval_profile,
                               train_dropout_0_1=moe_train_drop,
                               train_dropout_0=moe_train_nodrop,
                               train_profile=moe_train_profile,
                               fp32_loss_rel=moe32_loss,
                               fp32_grad_rel_l2=moe32_grads,
                               fp32_free_routing=dict(
                                   loss_rel=moe32_free[0],
                                   grad_rel_l2=moe32_free[1],
                                   decisions_differing=moe32_flips)),
                           switchhead=dict(rel_l2=sw_errs, ms=sw_ms,
                                           plain_attention_ms=sw_plain_ms),
                           parti=parti, parti_train=parti_train,
                           muse_train=muse_train, vqgan=vqgan,
                           vqgan_train=vqgan_train, muse_vqgan=muse_vqgan,
                           muse_vqgan_train=muse_vqgan_train,
                           transformer=transformer,
                           agent_bf16_vs_fp32_rel_l2=ag_err,
                           longcontext=dict(rows=lc_rows, t16384_rel_l2=lc_err),
                           ring=ring, flash_bthd_rel_l2=bthd_errs,
                           flash_fwd_ptxas=ptxas,
                           flash_bwd_ptxas=bwd_ptxas,
                           mlp_ptxas=mlp_ptxas, fma_ptxas=fma_ptxas,
                           mlp_vs_library=mlp_turns,
                           tile_product_forms_rel_l2=form_errs,
                           int8_form_bit_equal=s8_equal,
                           layernorm_vs_library=ln_turns,
                           codebook_vs_library=codes_turns,
                           fp32_product_layouts_rel_l2=f32_form_errs,
                           bwd_vs_library=bwd_turns,
                           flash_bwd_vs_sdpa=bwd_vs_sdpa,
                           flash_fwd_vs_sdpa=fwd_vs_sdpa,
                           flash_fwd_host_us=host_us),
                      f, indent=1)
    amt.sync()
    print(f"[nvidia-smi] {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def profile(torch, run, warm, label, host_rows=0):
    """Device time by kernel over ``run()`` (torch.profiler), after one
    ``warm()``, the share of the traced window's wall time the card was
    busy, and the host's side (``host_time``); the ``host_rows`` largest
    host ops by their own CPU time are printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    warm()
    torch.cuda.synchronize()
    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, attr):
                return getattr(e, attr)
        return 0.0

    # device-side events only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched, and so does a user annotation
    # on the device timeline ("Optimizer.step#OptaxAdam.step"); the
    # profiler's own buffer requests are not work
    events = prof.key_averages()
    rows = sorted(((e.key, dev_us(e) / 1e3, e.count)
                   for e in events
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith(("Optimizer.", "Activity Buffer"))),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[profile] {label}: wall {wall_ms:.3f} ms (traced), "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f} %)")
    for key, ms, count in rows[:20]:
        print(f"[profile]   {ms:9.3f} ms {100 * ms / busy:5.1f} % x{count:<4d}"
              f" {key[:90]}")
    host = host_time(prof, DeviceType.CPU, wall_ms)
    print(f"[profile] {label}, host: {host['op_ms']:.3f} ms of own CPU time"
          f" in recorded ops (all threads), {host['launches']} kernel "
          f"launches taking {host['launch_ms']:.3f} ms; the optimizer's "
          f"step {host['optimizer_ms']:.3f} ms, the autograd engine's "
          f"backward {host['backward_ms']:.3f} ms (CPU time with children "
          f"of its outermost nodes)")
    for key, ms, total, count in host["rows"][:host_rows]:
        print(f"[profile]   host {ms:9.3f} ms own, {total:9.3f} ms with "
              f"children x{count:<5d} {key[:70]}")
    return dict(wall_ms=wall_ms, busy_ms=busy, host=host,
                rows=[dict(key=k, ms=m, count=c) for k, m, c in rows])


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def host_time(prof, cpu, wall_ms):
    """The host's side of a trace (its ops on ``cpu``): the own CPU time
    of every recorded op, the kernel launches (count and time), the
    optimizer's ``step`` and the autograd engine's backward (CPU time with
    children of the outermost such events: a backward that runs
    ``autograd.grad`` inside nests engine events), and the 40 largest ops
    by own time with their time with children."""
    events = prof.key_averages()
    host = [e for e in events if e.device_type == cpu
            and not getattr(e, "is_user_annotation", False)]
    launch = [e for e in host if e.key in LAUNCH_CALLS]

    def outermost_ms(prefix):
        total = 0.0
        for e in prof.events():
            if e.device_type != cpu or not e.name.startswith(prefix):
                continue
            up = e.cpu_parent
            while up is not None and not up.name.startswith(prefix):
                up = up.cpu_parent
            if up is None:
                total += e.cpu_time_total
        return total / 1e3

    return dict(
        wall_ms=wall_ms,
        op_ms=sum(e.self_cpu_time_total for e in host) / 1e3,
        launches=sum(e.count for e in launch),
        launch_ms=sum(e.self_cpu_time_total for e in launch) / 1e3,
        optimizer_ms=outermost_ms("Optimizer.step#"),
        backward_ms=outermost_ms("autograd::engine::evaluate_function"),
        rows=sorted(((e.key, e.self_cpu_time_total / 1e3,
                      e.cpu_time_total / 1e3, e.count) for e in host),
                    key=lambda r: -r[1])[:40])


if __name__ == "__main__":
    sys.exit(main())
