#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (uncertainty_vit_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; it builds the port's CUDA
kernels from the sources in this checkout, then:

  phase 1  holds the attention forward (K1: at N <= 256 the streaming
           forward's kernel) against its plain PyTorch version at B=8, N in
           {197, 50, 256}, H=12, D=64, in bf16 (the model's compute dtype)
           and f32, over bias / no bias, q/v bias / none, bounded / exact
           softmax and with / without the row log-sum-exp; then holds its
           in-kernel dropout (rates 0.1 and 0.3) against the plain
           version's, which draws the same mask from the same seed, and
           checks that the lse is the undropped softmax's and that with zero
           scores and v = 1 the kernel's output is the plain version's to the
           bit (each row's kept count). Then holds and times it
           at the ViT-B/16 224 eval shape (B=128, N=197, bf16, bias,
           bounded), at the train step's B=160 with the lse and at the
           MC-dropout shape (B=1024), with rate 0 and rate 0.1, beside the
           plain version and one scaled_dot_product_attention call at B=128
           (the plain version at B=160 and 1024 computed 128 images at a
           time).
  phase 2  runs evaluate() of a full-width ViT-B/16 224 (beit_base_patch16_224,
           shared rel-pos bias, layer scale 0.1, 1000 classes, seeded random
           weights, bf16 compute on f32 params) over 4 batches of 128
           synthetic uint8 images, checks that every block launched K1, checks
           the logits against the same weights on the plain attention path and
           the metrics against a CPU recomputation, and measures the eval
           forward rate of both models.
  phase 3  holds the attention backward (K2: at N <= 256 the streaming
           backward's two kernels, the row sums formed from the forward's
           output) against its plain PyTorch version at B=8, N in {197, 50,
           256}, bf16 and f32, over bias / none, q/v bias / none, an lse
           from a bounded and from an exact K1 forward and dropout 0 / 0.1
           (the mask replayed), once with the row sums recomputed as
           rowsum(t) and once formed from the same output (dq, dk, dv, dbias
           and dqvb each against its bound; dqkv bit-identical between two
           runs); plants NaN right before and behind qkv, g, the output and
           the lse and checks that no bit of out, lse or dqkv changes;
           checks that the autograd Function's gradient (K1 + K2) equals
           autograd through the plain forward in f32; that with zero scores
           and g = 1 K2's dv is the plain version's to the bit (the same
           mask); the Euler identity <df/dv, v> = 2f of f = sum(out^2)
           through the Function at rate 0.3, and that it fails when the
           backward is given another seed than the forward; that the route
           changes from K1/K2 to K3/K4 right above N=256. Then holds K2 with
           rate 0 and 0.05 against both plain backwards at the ViT-B/16 224
           train shape (B=160, N=197, bf16, bias) and times them there, and
           without dbias, beside autograd's backward of
           scaled_dot_product_attention.
  phase 4  runs full-width ViT-B/16 224 finetune train steps as bench.py
           configures them (batch 160, drop-path 0.1, layer decay 0.65, AdamW
           with weight decay 0.05 on a cosine LR, batch mixup, bounded-scores
           softmax, bf16 compute on f32 params), checks that every step
           launched K1 and K2 once per block and that loss, grad norm and
           parameters are finite and the parameters moved, holds one step
           against the same step on the plain attention path, measures the
           train-step rate of both, and takes one step with attention dropout
           0.05 (the mask drawn in K1 and replayed in K2), held against the
           same step with the attention on its plain versions, which draw the
           same masks from the same seeds.
  phase 5  holds the fused dropout kernel (K8) against its plain PyTorch
           version to the bit, in bf16 and f32, at rates 0.1 and 0.5, on
           [8*197, 768], [3, 50, 64], a ragged [1001] and a misaligned view;
           then its row window (sequence parallelism: each rank's rows of a
           K*B fold draw the unsharded mask's rows) over WINDOW_CASES (577
           tokens split 289 / 288, at G = 64 phase 25's shape, 5 split 3 / 2
           at C = 768 and at C = 5, the element path; 13 over 4 ranks; one
           slab of 7 tokens at C = 6), against its plain version
           and the unwindowed call's rows, to the bit; then times it at the
           MC-dropout shape [1024*197, 768] bf16 beside the plain version,
           F.dropout and the same bytes as a window ([1024, 197 of 394,
           768]).
  phase 6  runs evaluate_mc_dropout() of the full-width ViT-B/16 224 with
           drop_rate 0.1 over 2 batches of 128 synthetic images, K=8 samples:
           (a) folded into one batch of 1024 at full depth and (b) with the
           trunk split at block 9 on a model whose dropout starts there.
           Checks per forward K1 12 launches, K8 24 in (a) and 6 in (b), K2
           none; that the [K, B, C] logits are finite, differ between
           samples, and are bit-identical from the same generator seed; that
           (a)'s forward agrees with the same forward on the plain attention
           and (b) with the folded forward of the same model and seed; that
           the metrics equal a CPU recomputation from the mean logits; then
           one forward with attention dropout 0.1, held against the plain
           attention with the same masks, and a 2-member evaluate_ensemble().
           Prints ms per K*B pass and its ratio to the deterministic forward
           ("pass-equivalents"). After it no ViT-B path may have launched a
           streaming kernel.
  phase 7  holds the streaming attention forward (K3), through the routed
           call, against its plain version at B=2, N in {257, 577, 1025}, H=16,
           in bf16 and f32, over bias / none, q/v bias / none, bounded / exact
           softmax, dropout 0 / 0.1 and with / without the lse (K1's
           tolerances; the lse with dropout bit-equal to the rate-0 lse); then
           holds and times it at the ViT-L/16 512 eval shape (B=16, N=1025,
           bf16, bias, bounded) and, with the lse, at the train step's B=8;
           also timed without bias, with the q/v bias, with the lse and with
           dropout 0.1, in turns
           with K1 at the same shape, one scaled_dot_product_attention call
           and the plain version (4 images at a time).
  phase 8  holds the split streaming backward (K4: two kernels behind one
           call; the row sums formed from the forward's output, which the
           backward now takes), through the routed call, against its two
           plain versions over the same grid of cases, once with the row
           sums recomputed as rowsum(t) (the function, as the JAX kernels
           form it) and once formed from the same output (dq, dk, dv, dbias
           and dqvb each against K2's bound relative to max|plain|; dqkv
           bit-identical between two runs); plants NaN right before and behind qkv, g, the output and
           the lse at N=577 and 1025 and checks that no bit of out, lse or
           dqkv changes;
           checks the Function's gradient (K3 + K4, f32) against autograd of
           the plain forward, and the Euler identity at rate 0.3 and its
           failure from another seed; then holds and times K4 at the ViT-L/16
           512 train shape (B=8, N=1025, bf16, bias) with rate 0 and 0.05,
           without dbias and with the q/v bias, beside autograd's backward of
           scaled_dot_product_attention and the plain versions.
  phase 9  the large-N slice: a full-width, full-depth ViT-L/16 512
           (beit_large_patch16_512: width 1024, depth 24, 16 heads, N=1025,
           shared rel-pos bias, layer scale 0.1, bf16 compute on f32 params)
           whose seeded weights are first carried across from the 224 model of
           the same width by resize_state_dict (rel-pos table from the 14 x 14
           to the 32 x 32 window). evaluate() over 2 batches of 16 uint8
           images (K3 24 launches per forward, K1 none; logits against the
           plain attention; metrics against a CPU recomputation); 3 finetune
           train steps at batch 8 (K3 and K4 24 per step, K1/K2 none; every
           parameter finite and moved); one step at batch 2 and one with
           attention dropout 0.05 held against the same steps with the
           attention on its plain versions; one K=2 MC forward of batch 4 with
           attention dropout 0.1 likewise. Prints img/s and peak memory as
           information.
  phase 10 holds the quantizing int8 matmul (K6) against its plain PyTorch
           version (the same rounding bits from the same seed): bf16 and f32,
           round-to-nearest and stochastic, with and without bias, at every
           (K, N) of ViT-B's and ViT-L's trunk and their dgrad transposes, M in
           {8, 197, 1000}, NaN planted around x; f32 within 1e-6 relative and
           bf16 within an ulp (equal to the bit is what is expected and
           printed); the same at K = 5120 and 6400 (past every trunk), and at
           M = 3333, K = 5120, N = 1280, where the persistent walk wraps and
           ends on a ragged row tile; then holds and times it at the train
           step's M = 31,520 (bf16; forward with bias, dgrad stochastic) for
           qkv, proj, fc1 and fc2 beside the plain version, F.linear in bf16
           (what the int8 layer replaces), torch._int_mm between plain
           quantize and dequantize passes (the library yardstick) and
           torch._int_mm alone on operands quantized beforehand, with K6's two
           kernels timed apart (torch.profiler).
  phase 11 holds the int8 wgrad (K7: two kernels behind one call) against its
           plain version over the same shapes: the int32 sums equal, and
           bit-identical between two runs, NaN planted around x and g; then
           holds and times it at M = 31,520 (wgrad() with its column-scale
           passes, and K7's two kernels alone, also apart) beside the plain
           version, the bf16 product, torch._int_mm between plain quantize,
           transpose and dequantize passes, and torch._int_mm alone on
           operands quantized beforehand (both with the tokens contiguous,
           as K7's product reads them).
  phase 12 the int8 slice: full-width, full-depth ViT-B/16 224 with
           quant="int8", otherwise phase 2's and phase 4's models. evaluate()
           over 4 batches of 128 (K6 48 launches per forward, K1 12, K7 none;
           logits against the same forward with K6 on its plain version); 3
           finetune train steps at batch 160 (per step K6 96, K7 48, K1 and K2
           12; every parameter finite and moved); one step held against the
           same step with K6 and K7 on their plain versions. Prints img/s
           beside the bf16 trunk's from the same turns, the int8 step's loss
           beside the bf16 step's on the same batch, and peak memory.
  phase 13 the ViT-H slice (head width 80, which the JAX package's kernels
           take too): (a) phases 1, 3, 7, 8 and 14 at D=80, H=16 (their
           cases, tolerances and checks; K1 timed at B=128 and K2 at the
           train step's B=32, K3-K5 at phases 7, 8 and 14's shapes); (b) a
           full-width, full-depth beit_huge_patch16_224 (width 1280, depth
           32, shared rel-pos bias, layer scale 0.1, seeded weights, bf16 on
           f32 parameters): evaluate() over 2 batches of 64 (K1 32 a forward
           and nothing else; logits against the plain attention, metrics
           against a CPU recomputation from the same logits), 3 finetune
           steps at batch 32 (K1 and K2 32 a step, every parameter finite
           and moved), one step against the plain attention and one with
           attention dropout 0.05 against the plain versions on the same
           masks; (c) cli.finetune --model beit_huge_patch16_224 from a
           seeded .pth over seeded 32x32 CIFAR-100 pickles: --eval over 256
           images at batch 64 (K1 32 a forward; logits against the plain
           attention, printed metrics against a CPU recomputation) and a
           train epoch of 2 steps at batch 32 with its evaluation of 64
           images (K1 and K2 32 a step), step 0 against the plain
           attention's. Prints the rates and peak memory as information.
  phase 14 holds the cross attention of sequence-parallel attention (K5: K3's
           and K4's entries given Nq query rows against Nk keys) against its
           plain versions at Nq in {1, 63, 257, 513}, Nk in {65, 577, 1025},
           B=2, H=16, bf16 and f32, over bias / none, q/v bias / none and
           bounded / exact softmax (K1's and K2's bounds, the backward
           against the plain versions with the row sums recomputed and with
           them formed from the output, as phase 8; dq and dkv bit-identical
           between two runs); plants NaN around q, kv, g, the
           output and the lse; holds the S shards of K5 together against K3's
           output and K4's dqkv, dbias and dqvb of the whole sequence at N =
           577 and 1025
           for S = 2 and 4; then times one shard at B=8, N=1025 for S = 2
           (Nq = 513) and 4 (Nq = 257), forward with the lse and backward,
           beside K3 and K4 of the whole sequence, the plain versions and the
           library call (scaled_dot_product_attention with the bias as its
           mask, and autograd's backward of it).
  phase 15 the sequence-parallel slice: phase 9's ViT-L/16 512 on phase 9's
           weights with its tokens split over S = 2 gloo ranks that share the
           one card (rows 0-512 and 513-1024; k/v gathered through host
           memory): evaluate() over one batch of 16 and 2 train steps at batch
           8, per rank K5 24 launches per forward and 24 backward per step,
           K1-K4 none; logits equal on both ranks and within phase 2's bound
           of the unsharded model's on the same batch, the first step's loss
           and grad norm within phase 4's bounds of the unsharded step's.
           Prints each rank's rates and peak memory as information: two ranks
           on one card over gloo are not a throughput of sequence parallelism.
  phase 16 the finetune driver from images: cli.finetune.main on the card
           over a CIFAR-100 test pickle of 1024 seeded 32x32 images and .pth
           files of phase 2's ViT-B/16 224 (100 classes) written here. --eval
           at batch 128 (the 32 -> 224 eval transform on the card): K1 96
           launches and no other kernel, its logits within phase 2's bound of
           the plain attention's on the same transformed images, its printed
           metrics equal to a CPU recomputation from those logits, the
           transform within 1e-5 of the CPU's. Over the first 256 images:
           --mc_dropout (K=8, split and dropout from block 9; K1 24, K8 12),
           --ensembles of two .pth (K1 48; each member's and the mean's
           printed metrics equal to a CPU recomputation from that member's
           logits on the same batches) and --quant int8 (K1 24, K6 96; its
           printed metrics equal to a CPU recomputation from its logits, and
           those logits within phase 2's bound of the same model's on qmm's
           plain version). Prints the --eval rate from images beside phase 2's forward, the
           card's busy share in one torch.profiler trace of the eval, and
           whether the native IO library was built.
  phase 17 the finetune driver's training from images: cli.finetune.main
           without --eval over CIFAR-100 pickles of 1280 train and 256 test
           seeded 32x32 images, from a .pth of phase 16's ViT-B/16 224, at
           batch 160, 2 epochs of 4 steps, layer decay 0.65, drop-path 0.1
           and the driver's default train transform (random resized crop,
           flip, RandAugment rand-m9-mstd0.5-inc1, erasing 0.25) and mixup /
           cutmix / smoothing: K1 and K2 12 launches a step, K1 12 an eval
           forward, no other kernel; finite losses; log.txt's two records
           with test_acc1 and test_ece; checkpoint-0, -1 and -best.pth. The
           driver's step 0 against the same run's step 0 on the plain
           attention (phase 4's bounds). The train transform on the card
           against the CPU's on the same draws (the crop within 1e-5; the
           whole within its level-flip bounds, AUG_*). The same command with
           --epochs 3 auto-resumes at epoch 2: its model and AdamW moments
           equal checkpoint-1.pth's to the bit, its step is 8 and its first
           lr the schedule's at update 8. An int8 epoch of 2 steps: K6 96 and
           K7 48 a step. Prints the driver's train rate from images beside
           phase 4's step-only rate, the transform's ms per batch (CUDA
           events), each epoch's evaluation time, and the card's busy share
           and idle time in a torch.profiler trace of two driver steps.
  phase 18 the finetune driver's slice 7c at 384 over seeded 32x32 CIFAR-100
           pickles (128 train, 64 test) from a .pth of phase 16's ViT-B/16
           224: (a) beit_base_patch16_384 --input_size 384 at batch 32,
           --update_freq 2, --masked_position_prob 0.1, --mixup_mode elem
           with --cutmix_minmax 0.2 0.8: 4 mini-steps (2 updates) and an
           evaluation of 64 images, K3 and K4 12 launches a mini-step, K3 12
           an eval forward, no other kernel; the parameters unchanged after
           mini-step 0 and moved after mini-step 1, lr at the update index;
           mini-step 0 within phase 4's bounds of the plain attention's; a
           warm mini-step under torch.cuda.set_sync_debug_mode("error"); a
           2-step --mixup_mode pair epoch; the elem and pair mixes on the card
           within 1e-6 of the CPU's on the same draws. (b) the same without
           mixup over two gloo ranks sharing the card (cli.finetune.run_rank,
           as main runs it under --seq_parallel 2): 2 steps at batch 8 and
           --eval over 64 images, K5 12 a forward and 12 a backward on each
           rank, K1-K4 none; step 0's loss within phase 4's bound and each
           leaf's gradient norm within phase 15's of the unsharded driver's
           step 0; the ranks' parameters equal; log.txt of one rank. (c)
           beit_large_patch16_384 --eval from a ViT-L/16 224 .pth over 64
           images at batch 16: K3 24 a forward, logits within phase 2's bound
           of the plain attention's. Prints the rates and times as
           information.
  phase 19 slice 8 through the driver, phase 16's ViT-B/16 224 (100 classes)
           from its .pth over seeded 32x32 CIFAR-100 images: (a) --sngp
           training at batch 160, an epoch of 4 steps and its evaluation of
           256 images (K1 and K2 12 a step, K1 12 an eval forward), step 0
           within phase 4's bounds of the plain attention's, the precision
           matrix within 1e-4 (of its largest entry) of a float64 CPU
           recomputation from the pooled features the card produced, |u| =
           |v| = 1 and the spectral estimate of the normalised fc_norm weight
           <= 0.95; then --sngp_cov_momentum 0 --epochs 2 auto-resumes from
           checkpoint-0.pth: the matrix is ridge·I before the first resumed
           step and ridge·I + the float64 sum of the 2 steps after. (b)
           --het_layer: 2 train steps, then --eval over 1024 images at batch
           128 (K1 96): the logits equal between two runs of a seed and not
           between seeds, the printed metrics equal to the CPU's from them;
           prints its rate and --sngp's beside the plain --eval's, in turns.
           (c) from the .pth over 256 images labelled by the model (80%
           right): --temp_scaling on each split (T* as good a minimizer of
           the CPU's NLL on the card's logits as the CPU's own fit;
           the metrics at T* equal to the CPU's), --laplace probit and mc
           fitted on 1024 train images (the factors and the predictive
           against a float64 CPU recomputation from the card's features;
           the printed metrics equal to the CPU's, the mc link's from the
           card's softmax probabilities, as its tied k/32 probabilities
           round apart between card and CPU; prints the fit's ms),
           --corrupted_data over 3 distortions of 320 images
           plain, --mc_dropout and --laplace, --perturbed_data over 2
           perturbations of 16 videos x 8 frames plain and --mc_dropout
           (each printed number equal to the CPU's from the card's logits,
           K1 12 a forward, K8 24 a forward under --mc_dropout), and
           --visualize_embedding (the TSVs the card's pooled features).
  phase 20 the cyclical (data2vec) pretraining driver, cli.pretrain_cyclical,
           over 1024 seeded 32x32 CIFAR-100 images at the recipe's flags
           (BASELINE.md:34: beit_base_patch16_224 at batch 128, lr 2e-3, mask
           120, EMA 0.9998 from 0.999, clip 3.0, drop-path 0.25, attention
           dropout 0.05, target layers 6-11), from random seeded weights: (a)
           2 epochs of 4 steps, BOUNDED_SCORES left on before main() (as phase
           4 and the finetune driver leave it): K1 24 (the teacher's 12
           without the lse, the student's 12 with it and its dropout) and K2
           12 a step, no other kernel, the exact softmax in every step; finite
           losses; log.txt's records under the JAX driver's keys; each step's
           masks the host op's from the step's CPU generator; the teacher
           after steps 0 and 1 the EMA rule on float64 copies within 1e-6; a step
           under torch.cuda.set_sync_debug_mode("error"); step 0 against the
           same run on the plain attention (phase 4's bounds); the pretrain
           transform on the card against the CPU's on the same draws (phase
           17's AUG_* bounds); --epochs 3 auto-resumes at epoch 2 with the
           student, teacher and AdamW moments of checkpoint-1.pth. Prints the
           rate beside phase 4's, a step's parts (transform, teacher and
           targets, student forward and backward, AdamW, EMA: CUDA events; the
           masks on the host) and a torch.profiler trace of two resumed steps
           (busy share, idle time, top kernels). (b) --gp_layer, 2 steps: the SNGP lm_head's
           precision matrix within 1e-4 (of its largest entry) of a float64
           recomputation from its [B·N, C] inputs. (c) the last checkpoint
           through cli.finetune --finetune --eval over 256 images (K1 24): the
           missing and unused keys those of import_torch_state_dict on the
           CPU (fc_norm and the head; mask_token, norm and lm_head). (d) one
           --quant int8 step: K6 144 (the teacher's forward quantizes too,
           48; the student's forward and dgrad 96), K7 48.
  phase 21 the BEiT pretraining drivers over 1024 seeded 32x32 CIFAR-100
           images: (a) cli.train_dvae at 112, vocab 8192, codebook 512, 3
           layers, hidden 64, batch 128, 4 steps: step 0's loss within 1e-4
           of a float64 recomputation on the card (same weights, images,
           Gumbel draws), a step under sync debug mode, no kernel launched,
           and with TF32 on before main() every forward and backward of the
           step's first and last convolutions without it;
           (b) cli.pretrain_beit at the MIM recipe (BASELINE.md:36,
           RECIPES.md:54-65: beit_base_patch16_224_8k_vocab at batch 128, lr
           1.5e-3, warm-up 10 epochs, mask 75, the tokenizer view at 112, clip
           3.0) with the full-width DALL-E tokenizer (n_hid 256, vocab 8192)
           from seeded weights pickled through stand-in dall_e classes: 2
           epochs of 4 steps (K1 12 / K2 12 a step, no other kernel, the exact
           softmax, the masks the host op's, a step under sync debug mode),
           step 0 against the plain attention, 32 views' tokens against a
           float64 copy of the tokenizer (a token may differ only where the
           float64 top-two gap is below twice the largest logit error), the two
           views against the CPU's, a resumed third epoch equal to
           checkpoint-1.pth, a step's parts by CUDA events (the tokenizer also
           under TF32 and bf16, information only; with TF32 on in the process
           its own call runs without it), an int8 step (K6 96, K7
           48); (c) cli.pretrain_joint at phase 20's recipe plus
           --vae_loss_weight 30 with (a)'s tokenizer: 2 epochs of 4 steps (K1
           24 / K2 12 a step), the teacher after steps 0 and 1 the EMA rule in
           float64, beit_weight 1 then 29/30, step 0 against the plain
           attention; (d) (b)'s checkpoint-2.pth through cli.finetune
           --finetune --eval (K1 24): the keys import_torch_state_dict gives
           on the CPU. Prints the rates beside phases 4 and 20.
  phase 22 the dist (mean+covariance) model through the drivers over 1024
           seeded 32x32 CIFAR-100 images from seeded weights, K1-K8 never
           launched: (a) cli.finetune --stochastic training of
           dist_beit_base_patch16_224 at the finetune recipe (RECIPES.md:35-45:
           batch 128, lr 4e-3, layer decay 0.65, drop-path 0.2, mixup 0.8,
           cutmix 1.0, weight decay 0) from a seeded .pth, 2 epochs of 4
           triplet steps and their evaluations: finite losses, log.txt,
           checkpoints, a step under sync debug mode; step 0's loss, CE,
           Wasserstein term and grad norm on a sub-batch of 32 (the driver's
           weights, transforms, mixup and draws) in bf16 and f32 against a
           float64 copy (DIST_* bounds); the distance's two products at
           [128, 12, 197, 64] against float64 with TF32 on in the process;
           step ms by CUDA events, the rate, peak memory. (b) --eval
           --stochastic of its checkpoint: dist_eval's metrics and the rate.
           (c) cli.pretrain_cyclical --stochastic at the cyclical recipe
           (phase 20's, layer scale 1e-4, --post_target_layer_norm,
           lambda_pretraining 1e-5), an epoch of 4 steps: the teacher's mean
           and cov targets and step 0's terms on a sub-batch against float64;
           the rate beside phase 20's.
  phase 23 slice 12 through cli.finetune from a seeded ViT-B/16 224 .pth over
           seeded 32x32 CIFAR-100 images: (a) --sinkformer, --gumbel_softmax,
           --h_sto_trans: 2 train steps at batch 32 (K1-K8 0 launches, the
           second under sync debug mode) and --eval over 64 images; the
           trained weights' logits of 4 images in f32 and bf16 against a
           float64 copy on the same Gumbel noise (VARIANT_LOGIT_REL_BOUND),
           the dual_sto block 0's two hard draws: their scores against the
           float64 copy's (VARIANT_LOGIT_REL_BOUND of max|scores|), the
           argmax where the top-two gap exceeds HARD_GAP_FACTOR times that
           error, on most positions; (b) 3 updates of every --opt
           (PHASE23_OPTS; lamb also at --update_freq 2) at batch 32, K1 12 /
           K2 12 a step, each update against a float64 recomputation of the
           same transform on the same gradients and state
           (OPT_UPDATE_REL_BOUND), adafactor's second epoch resumed from the
           straight run's checkpoint-0.pth (RESUME_REL_BOUND); (c) --opt
           adahessian, 3 steps at batch 64 under a slow warm-up (lr 0, then
           base/29, then 2·base/29) through cli.finetune (and with --quant
           int8: K6 96, K7 48 a step), cli.pretrain_cyclical (attention
           dropout 0.05: K1 24, K2 12) and --stochastic (none): every loss
           finite, the last after a nonzero update; no kernel inside the
           Hessian pass, the third step's pass by CUDA events, the peak
           memory, the update alone; z . Hz of an f32 model on 4 images
           against a float64 copy with the same z (HVP_REL_BOUND).
  phase 24 the device mesh (data x seq x model) over gloo ranks that share the
           card (parallel.mesh, parallel.dryrun), kernels built here first:
           24a ViT-B/16 224 at full width and PHASE24_DEPTH (4) of its 12
           blocks (shared rel-pos bias, layer scale 0.1, drop-path 0.1; 12
           heads, 6 a rank) on a data 2 x
           model 2 mesh of 4 ranks at global batch PHASE24_BATCH in f32: one
           cyclical step, one finetune step with batch mixup and the SNGP
           head, one dist triplet step, each from the same seeded weights
           and draws as the same step of one unsharded process on the card,
           held to it (parallel.dryrun.compare: the loss and the
           gradient's global norm at rtol 1e-4, the gathered parameters at
           rtol 1e-3 / atol 1e-4 where the unsharded gradient is above
           1e-6, within 2 lr elsewhere), the SNGP
           precision moved, every rank's gathered parameters equal; K1 8 /
           K2 4 (cyclical) and K1 4 / K2 4 (finetune) on each rank, none
           (dist); 24b python -m uncertainty_vit_tpu_torch.parallel.dryrun
           --devices 8 (the JAX dry run's 2 x 2 x 2 mesh and tiny trunk, 8
           ranks): the same holds, K5 on every rank of the seq axis. It
           prints the seconds of each engine's first step and of a second
           one over gloo: ranks that share one card through host memory,
           not a multi-card throughput.
  phase 25 slice 15: cli.finetune --seq_parallel 2 at ViT-B/16 384
           (beit_base_patch16_384, N = 577, from a ViT-B/16 224 .pth with a
           100-class head; PHASE25_SIZES seeded 32x32 CIFAR-100 images) on
           two gloo ranks sharing the card (chip_smoke.seq_eval_rank calls
           cli.finetune.run_rank in each): an --sngp --gp_layer and a
           --het_layer epoch of 2 steps (each writes checkpoint-0.pth), then
           MC-dropout K=8 folded and split at 9, --sngp --gp_layer and
           --het_layer --eval from those checkpoints, --temp_scaling,
           --laplace, -C --mc_dropout, -P (at ViT-B/16 224: CIFAR-P frames
           are resized to 256 before the crop, so both packages refuse -P
           above 256) and --visualize_embedding; then each in one process
           (and -C --mc_dropout from --seed 1). Holds the launches of every
           run on each rank (K5 12 a forward, K5's backward 12 a step, K8 24
           a folded forward and 6 a split one, no other kernel) and in one
           process (K3 / K4 in K5's place, K1 for -P); every array rank 0
           read back (logits, features, labels) against the one process's
           (LOGIT_REL_BOUND of max|value|, PHASE25_MC_REL_BOUND where the
           dispatch draws masks; labels equal); that the --seed 1 masks move
           the -C logits by more than PHASE25_MC_REL_BOUND; T*
           (PHASE25_T_LOG_BOUND) and the Laplace prior (a grid point apart);
           each epoch's loss (LOSS_REL_BOUND); rank 0's dump. Prints the
           seconds of each run, the MC-dropout rate on the ranks and in one
           process, and rank 0's seconds in the k/v gathers of each run.
  phase 27 slice 17, checkpoints of the JAX package: (a) phase 16's ViT-B/16
           224 weights turned into the JAX package's FinetuneState tree
           (utils.checkpoint.state_dict_to_flax) and written by the
           converter's tree -> .pth half (tools/torch_port_orbax_to_pth.py
           write_pth), then cli.finetune --eval --finetune that file over
           phase 16's 1024 images: the logits and their metrics on the CPU
           equal to phase 16's to the bit, the driver's printed metrics
           within METRIC_RTOL / METRIC_ATOL (its calibration bins are a
           scatter_add on the card), K1 96 and nothing else; (b) the committed golden
           tests/golden_torch_port/orbax_vit64 (the converter's .pth of a
           FinetuneState the JAX package wrote, width 64 in one head, depth
           2; the JAX model's bf16 logits on 16 seeded images): the port's
           forward within LOGIT_REL_BOUND of the largest logit, the argmax
           wherever the top two stand further apart, K1 depth launches; (c)
           without tensorstore on the card, read_orbax_tree and the
           driver's --finetune DIR raise naming the converter.
  phase 28 slice 18, the finetune driver on the data x seq mesh: four gloo
           ranks sharing the card as the mesh (2, 2, 1) in one run_ranks call
           (chip_smoke.mesh_driver_rank calls cli.finetune.run_rank in each),
           at ViT-B/16 384's widths (768, 12 heads, N = 577) and 4 blocks
           (--target_layer 3), PHASE28_SIZES seeded 32x32 CIFAR-100 images,
           --batch_size 2 a data rank: (a) --eval in bf16, MC-dropout K=4
           folded and split at 2 and --het_layer in f32; (b) two epochs of
           training in f32 over an odd train split (padded shards), each
           evaluated over the union of the shards; (c) --sinkformer, an
           epoch of one step (f32) and --eval (bf16); (d) --opt adahessian
           on each seq pair as a mesh of one data index (f32), and again
           with the k/v gather's old backward. Then each run in one process
           given the global batch (BatchLoader(hosts_per_batch=2), batch 4;
           batch 2 for (d)). Holds every rank's launches (K5 a forward and
           K5's backward a block, K8 two a block that drops) and one
           process's (K3 / K4 in K5's place); every rank's logits against
           one process's rows of each global batch (LOGIT_REL_BOUND of
           max|logit| in bf16, PHASE28_F32_REL_BOUND in f32) and rank 0's
           metrics; each rank's first K8 mask through the fold against its
           plain version and one process's rows, to the bit; the steps'
           losses and gradient norms and each epoch's loss
           (PHASE28_F32_REL_BOUND), every rank's step count; D = z * Hz on
           the pair against one process's (PHASE28_HESSIAN_REL_BOUND), and
           the old backward's D outside that bound. Phase 5 also holds K8's
           batch fold (FOLD_CASES) against its plain version and one
           process's rows, and times it at [1024*197, 768].
  phase 29 slice 19, the finetune driver's data axis with nothing refused:
           four gloo ranks sharing the card as the mesh (2, 2, 1) in one
           run_ranks call (chip_smoke.data_axis_rank calls
           cli.finetune.run_rank in each, on the mesh or on its seq index's
           data pair as a (2, 1, 1) mesh), ViT-B/16 at 4 blocks
           (--target_layer 3) from seeded .pth files, PHASE29_SIZES seeded
           32x32 CIFAR-100 images, --batch_size 2 a data rank: (a) --quant
           int8 --seq_parallel 2 at 384 in f32: two epochs, step 0's
           gradients, the same step with every int8 layer's image offset at
           0 (the mutation), --eval in bf16, and a layer probe at the qkv
           shape (K6's dgrad and K7's int32 sums through the row window
           with the image offset, kernel against plain to the bit, the
           four ranks' sums adding up to one process's, the dgrad rows
           one process's); (b) --attn_drop_rate 0.05 on the data pairs: two
           steps at 224 (K1 / K2), one at 384 (K3 / K4), --eval
           --mc_dropout folded and split at 224 (K1, K8), f32; (c) --opt
           adahessian on (2, 2, 1) in f32, and with each rank's Hz share
           left unsummed over the data group; (d) --stochastic on the data
           pairs at 224: two epochs and --eval --stochastic (no kernel).
           Then each run in one process given the global batch
           (BatchLoader(hosts_per_batch=2), batch 4). Holds every rank's
           launches and one process's; the arrays read back and the
           metrics (LOGIT_REL_BOUND in bf16, PHASE28_F32_REL_BOUND in f32);
           the first K1 / K3 dropout mask of each run that draws, probed on
           the kernel (q = k = 0, v one-hot on 64 keys at a time) against
           its plain version in the rank and against one process's rows of
           the fold, to the bit, and K8's; the steps' losses and gradient
           norms and the epochs' losses (PHASE28_F32_REL_BOUND); step 0's
           int8 gradients, all of them and the last block's int8 weights
           (PHASE29_INT8_TOTAL_REL, PHASE29_INT8_LAST_REL), and the
           mutation outside both; D against one process's (PHASE28_HESSIAN_REL_BOUND) and the
           unsummed D outside it. Times K1 with dropout at B=128 N=197 flat
           and through the fold (64, 128, 64), and K6's stochastic qkv
           dgrad at M = 31,520 without a window and through the image
           offset 160, each pair in turns.
  phase 30 the attention kernels at every head width they are built for
           beyond 64 and 80 (D = 32, 48, 96, 112, 128; PHASE30_WIDTHS):
           (a) phases 1, 3, 7, 8 and 14 at each D, their cases, checks and
           tolerances in bf16 and f32, with H so that C = H D is a preset's
           width where one is (24 x 32, 16 x 48, 8 x 96 = 768; 8 x 112 =
           896; 6 x 128 = 768 for K1 / K2, 8 x 128 = 1024 for K3-K5), each
           kernel timed beside its bound and the library call at ViT-B/16
           224's and ViT-L/16 512's shapes; (b) full-width models through
           models.registry.create_model's num_heads override
           (PHASE30_MODELS): beit_base_patch16_224 with 6 heads of 128
           (evaluate() over 4 x 128, K1 12 a forward; 3 finetune steps at
           160, K1 / K2 12 a step), beit_large_patch16_512 with 8 heads of
           128 (evaluate() over 2 x 16, K3 24 a forward; 3 steps at 8, K3 /
           K4 24 a step), and ViT-B/16 224 with 24 heads of 32, 16 of 48 and
           8 of 96 (one eval batch of 128, one step at 160); each model's
           logits against the same weights on the plain attention
           (LOGIT_REL_BOUND), its evaluate() metrics against a CPU
           recomputation, and one step against the plain attention's
           (LOSS_REL_BOUND, GRAD_NORM_REL_BOUND; at 512 at batch 2); (c) a
           width the kernels are not built for: 16 heads of 72 (where the
           reference takes its kernels) raise NotImplementedError on the
           card, 8 heads of 72 (where it runs plain attention) run plain.

Prints the card's name and power limit first, a JSON line describing each
kernel second to last, and {"ok": true, "device": {...}} last. Any failed
check ends the run with a non-zero exit. There is no CPU path.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

# Phase-1 tolerances on the output, per input dtype: bf16 output against the
# plain version's bf16 output (both round once to bf16 from f32 arithmetic;
# the kernel's online softmax rounds e against a running max), f32 against
# f32 (sums in another order); and on the f32 lse.
OUT_TOL = {"bfloat16": 1e-2, "float32": 1e-4}  # atol = rtol
LSE_ATOL = 1e-3
# Phase-2 bound on |logits(kernel) − logits(plain attention)|, relative to
# max |logits(plain)|: both models run 12 bf16 blocks on the same weights and
# differ only in where the attention rounds to bf16.
LOGIT_REL_BOUND = 5e-2
# Metrics on the card against the same metrics on the CPU (f32 sums in
# another order).
METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-5
# Phase-3 bounds on max|kernel − plain| relative to max|plain|, per input
# dtype. dqkv: bf16 rounds ds and p to bf16 before the products, and an ulp
# of difference in p flips some of those roundings (about K1's 1e-2); f32
# sums in another order. dbias: the kernel adds the batch's ds with f32
# atomics in a run-dependent order, so it is held looser in f32. dqvb sums
# dqkv in f32, so it inherits dqkv's bound.
BWD_TOL = {"bfloat16": {"dqkv": 2e-2, "dbias": 2e-2, "dqvb": 2e-2},
           "float32": {"dqkv": 1e-5, "dbias": 1e-4, "dqvb": 1e-5}}
# The Function's gradient (K1 + K2, f32) against autograd through the plain
# forward, relative to the largest gradient entry.
GRAD_REL_BOUND = 1e-4
# Phase 4: one train step on the kernel path against the same step on the
# plain attention path (same weights, same generator seeds). Both run 12
# bf16 blocks and differ only in where the attention rounds to bf16.
LOSS_REL_BOUND = 1e-2
GRAD_NORM_REL_BOUND = 5e-2
# Phase 15: each parameter's gradient norm after the sharded step's group sum
# against the unsharded step's (same weights, batch and seeds). The sharded
# backward sums two bf16 shares of each k/v cotangent where K4 rounds one f32
# sum, so a leaf's norm moves by a few bf16 roundings (read on an H100: the
# worst of 369 leaves, cls_token, 6.7e-4, the median 1.4e-5); a gradient left
# unsummed or summed twice moves it by tens of percent.
LEAF_GRAD_REL_BOUND = 5e-3
# The Euler identity <df/dv, v> = 2f of f = sum(out^2) holds to f32 rounding
# when the backward replays the forward's dropout mask and breaks at the
# percent level when it does not (tests/test_flash_attention.py:102-123).
EULER_RTOL = 1e-3
# Published peaks of one H100 SXM (NVIDIA's data sheet), for the bounds: the
# least time the card could take is the larger of bytes / memory rate and
# operations / peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
# Phase 10: K6 against its plain version. Both quantize every entry alike (the
# same rounding bits), the int32 sums are exact, and the dequantizing products
# and the bias add are rounded one by one in the same order, so the results
# should be equal; the bound allows the last rounding of the output type (an
# f32 ulp; half a bf16 ulp, 2^-8, either way).
QMM_REL_TOL = {"bfloat16": 2.0**-7, "float32": 1e-6}
# The fused kernels' token counts: ViT-B/16 224, a small N in one tile, and
# the route's edge (four whole tiles).
FUSED_N = (197, 50, 256)
# The streaming kernels' token counts: right above K2's limit, and the 384 and
# 512 presets' (both 1 mod 64: one valid row in the last q tile and one valid
# column in the last k/v tile).
BIG_N = (257, 577, 1025)
# Phase 17: the train transform on the card against the CPU's, on the same
# draws. The crop (on [0, 1]): the card forms a tap's position start + (i +
# 0.5)·step − 0.5 with a fused multiply-add, the CPU does not, so the
# position, and with it the fraction the cubic weights take, may differ by an
# ulp of the position (2^-19 below 32, the CIFAR side); the interpolation's
# slope is at most 1.25 over values in [0, 1], so each axis may move by
# ~2.4e-6 and the two together by ~5e-6, plus the products' own rounding
# (read on an H100: 7.3e-6). RandAugment casts to bf16 and reads 256-level
# tables, so a value within that difference of a bf16 or level edge lands on
# the other side: one bf16 ulp (2^-8, 0.0175 after normalizing) or the
# neighbouring table entry, a step of the op's slope / 255 (0.033 after
# normalizing for the enhance ops) and up to the whole range at the solarize
# threshold or a posterize / equalize step. The edges lie >= 2^-9 apart and
# the two crops ~1e-5 apart at most, so about 1e-4 of the elements may move
# (read on an H100: 2.5e-4 beyond 1e-4, 7.5e-7 beyond two bf16 ulps);
# several times that means another op.
AUG_CROP_ATOL = 2e-5
AUG_NEAR_ATOL, AUG_NEAR_SHARE = 1e-4, 2e-3
AUG_FLIP_ATOL, AUG_FLIP_SHARE = 2 * 2.0**-8 / 0.224, 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def bound(n_bytes: float, flops: float, dtype: str) -> tuple:
    """(bound_ms, bound_by) of work that moves n_bytes (each input read once,
    each output written once) and does flops operations in dtype."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def in_turns(fns: dict, iters: int) -> tuple:
    """Times the named functions in turns a, b, ..., b, a; returns (the
    least ms of each, both times of each)."""
    names = list(fns)
    runs = {k: [] for k in names}
    for name in names + names[::-1]:
        runs[name].append(cuda_ms(fns[name], iters))
    return {k: min(v) for k, v in runs.items()}, runs


def sdpa_packed(torch, qkv, bias_cast, scale, h):
    """One library call that computes what K1 computes (exact softmax): the
    head split, scaled_dot_product_attention with the bias as its mask, and
    the merge back to [B, N, C]. Timed as a yardstick; the port never calls
    it."""
    b, n, c3 = qkv.shape
    q, k, v = qkv.view(b, n, 3, h, c3 // (3 * h)).permute(2, 0, 3, 1, 4)
    o = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias_cast,
                                                         scale=scale)
    return o.transpose(1, 2).reshape(b, n, c3 // 3)


def slice_fold(start, step, batch):
    """The batch fold (b, start + b, start) of images [start, start + step)
    of a batch (b of them): the dropout mask of their place in the batch."""
    b = min(step, batch - start)
    return b, start + b, start


@contextlib.contextmanager
def attention_on_plain(torch, FA):
    """Inside, the attention wrappers compute with their plain versions on the
    card too (128 images at a time, 4 above N=256; same seeds and so same
    dropout masks) and launch none of K1 to K4: the reference that a run of
    a whole model on the kernels is held against. Only this script does so;
    the package never takes a plain version for a CUDA tensor."""
    fwd, bwd = FA._forward, FA.fused_qkv_attention_bwd

    def plain_fwd(qkv, bias, qv_bias, scale, h, bounded, want_lse, seed, rate, fold=None):
        if fold is not None:  # a data rank's images, keyed by their batch fold
            return FA.fused_qkv_attention_plain(qkv, bias, qv_bias, scale, h,
                                                bounded_scores=bounded, seed=seed,
                                                dropout_rate=rate, fold=fold)
        step = 128 if qkv.shape[1] <= 256 else 4
        parts = [FA.fused_qkv_attention_plain(qkv[i:i + step], bias, qv_bias, scale, h,
                                              bounded_scores=bounded, seed=seed,
                                              dropout_rate=rate,
                                              fold=slice_fold(i, step, qkv.shape[0]))
                 for i in range(0, qkv.shape[0], step)]
        return torch.cat([o for o, _ in parts]), torch.cat([l for _, l in parts])

    def plain_bwd(qkv, bias, qv_bias, lse, g, scale, h, *, out=None, want_dbias=True, seed=None,
                  dropout_rate=0.0, fold=None):
        dqkv, dbias, dqvb = FA.fused_qkv_attention_bwd_plain(
            qkv, bias, qv_bias, lse, g, scale, h, out=out, seed=seed, dropout_rate=dropout_rate,
            fold=fold)
        return dqkv, dbias if want_dbias else None, dqvb

    FA._forward, FA.fused_qkv_attention_bwd = plain_fwd, plain_bwd
    try:
        yield
    finally:
        FA._forward, FA.fused_qkv_attention_bwd = fwd, bwd


def cuda_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_split(torch, fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel that fn launches, by a short name
    (torch.profiler over `calls` calls after one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type.name == "CUDA" and not e.is_user_annotation:
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "", e.name).split("(")[0]
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / 1000.0 / calls
    return split


def build_kernels(_native) -> None:
    """Builds every csrc/*.cu at once and prints nvcc's seconds and ptxas's
    registers and spills per kernel instantiation (<..., kDrop or kVector>)."""
    t0 = time.perf_counter()
    libs = _native.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, (secs, log) in _native.BUILD_LOG.items():
        print(f"  nvcc {name}: {secs:.1f} s", flush=True)
        for entry, spills, used in re.findall(
                r"Function properties for (\S+)\n\s*(.*?)\nptxas info\s*: (Used \d+ registers)", log):
            short = re.search(r"\d+((?:attention|dropout|stream|quant\w*|wgrad|qmm)_\w+?E)E*v",
                              entry)
            print(f"    {short.group(1) if short else entry}: {used}, {spills}", flush=True)


def phase1(torch, FA, dev, h=12, d=64, train_b=160):
    """K1 at head width d with h heads (ViT-B's 12 x 64 unless given): the
    case grid, then the eval shape B=128 and the train step's B=train_b with
    the lse; at d = 64 also the MC-dropout shape B=1024."""
    gen = torch.Generator(device=dev).manual_seed(0)
    c, scale = h * d, d**-0.5
    worst_out = 0.0
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), FUSED_N):
        tol = OUT_TOL[str(dtype).split(".")[1]]
        qkv = torch.randn(8, n, 3 * c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        for has_bias, has_qvb, bounded in itertools.product((True, False), repeat=3):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            out, lse = FA.fused_qkv_attention(qkv, b_, q_, None, scale, h,
                                              bounded_scores=bounded, want_lse=True)
            out_only = FA.fused_qkv_attention(qkv, b_, q_, None, scale, h, bounded_scores=bounded)
            ref, ref_lse = FA.fused_qkv_attention_plain(qkv, b_, q_, scale, h,
                                                        bounded_scores=bounded)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            worst_out = max(worst_out, err)
            print(f"  K1 {str(dtype)[6:]} N={n} bias={has_bias:d} qv_bias={has_qvb:d} "
                  f"bounded={bounded:d}: max|out-plain|={err:.3e} max|lse-plain|={lse_err:.3e}",
                  flush=True)
            check(torch.isfinite(out.float()).all().item(), "K1 output is not finite")
            check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
                  f"K1 output disagrees with the plain version (max abs {err:.3e})")
            check(lse_err <= LSE_ATOL, f"K1 lse disagrees with the plain version ({lse_err:.3e})")
            check(torch.equal(out, out_only), "K1 output depends on want_lse")

    # in-kernel dropout: kernel and plain version draw one mask from one seed
    from uncertainty_vit_tpu_torch.ops import philox

    seed = torch.tensor([0x0123456789ABCDEF], dtype=torch.int64, device=dev)
    worst_drop = 0.0
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), FUSED_N):
        tol = OUT_TOL[str(dtype).split(".")[1]]
        qkv = torch.randn(8, n, 3 * c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        for has_bias, bounded, rate in itertools.product((True, False), (True, False),
                                                         (0.1, 0.3)):
            b_ = bias if has_bias else None
            out, lse = FA.fused_qkv_attention(qkv, b_, None, seed, scale, h, rate,
                                              bounded_scores=bounded, want_lse=True)
            out_only = FA.fused_qkv_attention(qkv, b_, None, seed, scale, h, rate,
                                              bounded_scores=bounded)
            _, lse0 = FA.fused_qkv_attention(qkv, b_, None, None, scale, h, 0.0,
                                             bounded_scores=bounded, want_lse=True)
            ref, _ = FA.fused_qkv_attention_plain(qkv, b_, None, scale, h, bounded_scores=bounded,
                                                  seed=seed, dropout_rate=rate)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - lse0).abs().max().item()
            worst_drop = max(worst_drop, err)
            print(f"  K1 dropout {rate} {str(dtype)[6:]} N={n} bias={has_bias:d} "
                  f"bounded={bounded:d}: max|out-plain|={err:.3e} "
                  f"max|lse-lse(rate 0)|={lse_err:.3e}", flush=True)
            check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
                  f"K1 with dropout disagrees with the plain version (max abs {err:.3e})")
            check(lse_err <= LSE_ATOL, f"K1's lse changes with dropout ({lse_err:.3e})")
            check(torch.equal(out, out_only), "K1 output with dropout depends on want_lse")
        # zero scores and v = 1: a row's output is its kept count times
        # 1/(1 - rate) over N, so the kernel's mask is the plain mask's
        ones = torch.zeros(8, n, 3 * c, device=dev, dtype=dtype)
        ones[..., 2 * c:] = 1.0
        for rate in (0.1, 0.3):
            out = FA.fused_qkv_attention(ones, None, None, seed, scale, h, rate,
                                         bounded_scores=False)
            ref, _ = FA.fused_qkv_attention_plain(ones, None, None, scale, h,
                                                  bounded_scores=False, seed=seed,
                                                  dropout_rate=rate)
            if dtype == torch.bfloat16:
                # sums of one bf16 value are exact in f32 in any order
                check(torch.equal(out, ref), f"K1's dropout mask is not the plain version's "
                      f"(bfloat16 N={n} rate {rate})")
                print(f"  K1 dropout {rate} N={n}: zero scores, v = 1: output equal to the plain "
                      f"version's to the bit (the same mask)", flush=True)
            else:
                kept = (philox.attention_bits(seed, 8, h, n, n) >= philox.threshold(rate)).sum(-1)
                got = (out.reshape(8, n, h, d)[..., 0] * n * (1.0 - rate)).round().long()
                check(torch.equal(got.transpose(1, 2), kept), "K1's kept count per row differs")
                frac = kept.sum().item() / (8 * h * n * n)
                print(f"  K1 dropout {rate} N={n}: kept counts per row equal the plain mask's; "
                      f"kept fraction {frac:.4f}", flush=True)
    try:
        FA.fused_qkv_attention(qkv, None, None, None, scale, h, 0.1)
        check(False, "K1 took a dropout rate without a seed")
    except ValueError:
        pass

    # the model's shapes, N=197, bias, bounded scores: the eval batch B=128,
    # the train step's B=train_b with the lse, and at d = 64 the MC-dropout
    # batch B=1024 (K=8 samples of batch 128 folded)
    mc = d == 64
    big = torch.randn(1024 if mc else max(128, train_b), 197, 3 * c, generator=gen,
                      device=dev).to(torch.bfloat16)
    qkv, train = big[:128], big[:train_b]
    bias = torch.randn(h, 197, 197, generator=gen, device=dev) * 0.5
    bias_cast = bias.to(torch.bfloat16)
    fwd = lambda x, rate=0.0, lse=False: (lambda: FA.fused_qkv_attention(  # noqa: E731
        x, bias, None, seed if rate else None, scale, h, rate, bounded_scores=True, want_lse=lse))
    kern, drop = fwd(qkv), fwd(qkv, 0.1)
    plain = lambda: FA.fused_qkv_attention_plain(qkv, bias, None, scale, h, bounded_scores=True)
    lib = lambda: sdpa_packed(torch, qkv, bias_cast, scale, h)

    def plain_sliced(x, rate):
        """The plain version 128 images at a time, each slice with the mask
        of its place in the batch: (out, lse)."""
        parts = [FA.fused_qkv_attention_plain(
            x[i:i + 128], bias, None, scale, h, bounded_scores=True, seed=seed,
            dropout_rate=rate, fold=slice_fold(i, 128, x.shape[0]))
            for i in range(0, x.shape[0], 128)]
        return torch.cat([o for o, _ in parts]), torch.cat([l for _, l in parts])

    def held_k1(what, got, want):
        got, tol = got.float(), OUT_TOL["bfloat16"]
        err = (got - want.float()).abs().max().item()
        print(f"  K1 bfloat16 D={d} {what} N=197 bias=1 bounded=1: max|out-plain|={err:.3e}",
              flush=True)
        check(torch.allclose(got, want.float(), atol=tol, rtol=tol),
              f"K1 at {what} disagrees with the plain version (max abs {err:.3e})")
        return err

    out, ref = kern().float(), plain()[0].float()
    err = (out - ref).abs().max().item()
    worst_out = max(worst_out, err)
    lib_err = (out - lib().float()).abs().max().item()
    print(f"  K1 bfloat16 B=128 N=197 bias=1 qv_bias=0 bounded=1: max|out-plain|={err:.3e}, "
          f"max|out-library call|={lib_err:.3e}", flush=True)
    check(torch.allclose(out, ref, atol=OUT_TOL["bfloat16"], rtol=OUT_TOL["bfloat16"]),
          f"K1 output disagrees with the plain version at the eval shape (max abs {err:.3e})")
    worst_drop = max(worst_drop, held_k1("B=128 dropout 0.1", drop(), plain_sliced(qkv, 0.1)[0]))
    del out, ref
    got, got_lse = fwd(train, lse=True)()
    want, want_lse = plain_sliced(train, 0.0)
    worst_out = max(worst_out, held_k1(f"B={train_b} with the lse", got, want))
    lse_err = (got_lse - want_lse).abs().max().item()
    check(lse_err <= LSE_ATOL, f"K1's lse disagrees at the train shape ({lse_err:.3e})")
    if mc:  # the shape the MC-dropout path gives K1 (12,288 (image, head) pairs)
        worst_out = max(worst_out, held_k1("B=1024", fwd(big)(), plain_sliced(big, 0.0)[0]))
        worst_drop = max(worst_drop, held_k1("B=1024 dropout 0.1", fwd(big, 0.1)(),
                                             plain_sliced(big, 0.1)[0]))
    del got, got_lse, want, want_lse
    lse_key = f"B={train_b} with lse"
    best, runs = in_turns({"plain": plain, "kernel": kern, "dropout 0.1": drop,
                           lse_key: fwd(train, lse=True), "library": lib}, 20)
    print(f"  K1 at B=128 N=197 H={h} D={d} bf16 (bias, bounded), ms per call: {runs}", flush=True)

    def k1_bound(x, lse):
        b_ = x.shape[0]
        return bound(nbytes(x, bias) + x.numel() // 3 * 2 + (4 * b_ * h * 197 if lse else 0),
                     4.0 * b_ * h * 197 * 197 * d, "bfloat16")

    bound_ms, bound_by = k1_bound(qkv, False)
    train_bound, _ = k1_bound(train, True)
    other = {"B=128 dropout 0.1": best["dropout 0.1"], lse_key: best[lse_key],
             f"{lse_key} bound": train_bound}
    if mc:
        best_big, runs_big = in_turns({"kernel": fwd(big), "dropout 0.1": fwd(big, 0.1)}, 10)
        big_bound, _ = k1_bound(big, False)
        other.update({"B=1024": best_big["kernel"], "B=1024 dropout 0.1": best_big["dropout 0.1"],
                      "B=1024 bound": big_bound})
        print(f"  K1 at B=1024 (the MC-dropout shape), ms per call: {runs_big}", flush=True)
    print(f"  K1 D={d} bounds: B=128 {bound_ms:.4f} ms, B={train_b} with the lse "
          f"{train_bound:.4f}" + (f", B=1024 {big_bound:.4f}" if mc else ""), flush=True)
    return {"max_abs_err": max(worst_out, worst_drop), "ms": best["kernel"],
            "plain_ms": best["plain"], "library_ms": best["library"], "bound_ms": bound_ms,
            "bound_by": bound_by, "other_ms": other}


def phase2(torch, FA, dev):
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )

    # the finetune driver's eval runs the bounded-scores softmax
    FA.BOUNDED_SCORES = True
    cfg = get_preset("beit_base_patch16_224", use_shared_rel_pos_bias=True, init_values=0.1)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    # the reference zero-initializes the rel-pos table; draw it so the bias
    # the kernel adds is not all zeros
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    plain_model = VisionTransformer(cfg.replace(use_flash_attention=False), dtype=torch.bfloat16,
                                    device=dev, generator=gen)
    plain_model.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  ViT-B/16 224: {n_params} params, depth {cfg.depth}, {cfg.num_classes} classes",
          flush=True)

    bs, nb = 128, 4
    images = [torch.randint(0, 256, (bs, 224, 224, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]

    def batches():
        for u8, lbl in zip(images, labels):
            yield normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD), lbl

    FA.fused_qkv_attention.launches = 0
    metrics = evaluate(model, batches())
    torch.cuda.synchronize()
    launches = FA.fused_qkv_attention.launches
    print(f"  evaluate(): {json.dumps(metrics)}", flush=True)
    check(launches == cfg.depth * nb, f"K1 launched {launches} times, expected {cfg.depth * nb}")
    check(all(math.isfinite(v) for v in metrics.values()), "non-finite metric")

    fwd, plain_fwd = make_eval_forward(model), make_eval_forward(plain_model)
    x0 = next(batches())[0]
    logits, ref = fwd(x0), plain_fwd(x0)
    torch.cuda.synchronize()
    check(tuple(logits.shape) == (bs, cfg.num_classes) and logits.dtype == torch.float32,
          f"logits {tuple(logits.shape)} {logits.dtype}")
    check(torch.isfinite(logits).all().item(), "non-finite logits")
    diff = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"  logits kernel vs plain attention: max|diff|={diff:.3e}, max|logit|={scale:.3e}, "
          f"ratio {diff / scale:.3e} (bound {LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * scale, "logits disagree with the plain-attention model")

    # metrics on the card against the same computation on the CPU, on
    # well-separated seeded logits (the random model's logits are all within
    # ~1e-3 of each other, where an ulp of softmax reorders AUROC ranks)
    lab = torch.randint(0, cfg.num_classes, (bs * nb,), generator=gen, device=dev)
    syn = torch.randn(bs * nb, cfg.num_classes, generator=gen, device=dev) * 2.0
    syn[torch.arange(bs * nb, device=dev), lab] += 2.0
    on_card = M.classification_metrics(syn, lab)
    on_cpu = M.classification_metrics(syn.cpu(), lab.cpu())
    for k in on_card:
        a, b = float(on_card[k]), float(on_cpu[k])
        check(abs(a - b) <= METRIC_ATOL + METRIC_RTOL * abs(b), f"metric {k}: card {a} vs cpu {b}")

    best, runs = in_turns({"plain": lambda: plain_fwd(x0), "kernel": lambda: fwd(x0)}, 5)
    rates = {name: [bs * 1000.0 / ms for ms in v] for name, v in runs.items()}
    print(f"  eval forward img/s at batch {bs}: kernel {rates['kernel']}, "
          f"plain attention {rates['plain']}", flush=True)
    return launches, best["kernel"]


def _rel_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), 1e-30)


def phase3(torch, FA, dev, h=12, d=64, train_b=160):
    """K2 at head width d with h heads (ViT-B's 12 x 64 unless given): the
    case grid and its checks, then the train step's shape B=train_b."""
    gen = torch.Generator(device=dev).manual_seed(1)
    c, scale = h * d, d**-0.5
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64, device=dev)
    worst, n_cases = 0.0, 0

    def parts(got):
        """(dqkv, dbias, dqvb) as (dq, dk, dv, dbias, dqvb)."""
        return (*got[0].chunk(3, dim=-1), got[1], got[2])

    def held(tag, got, qkv, b_, q_, lse, out, g, sd, rate, tol):
        """got = K2's (dqkv, dbias, dqvb), held against the plain backward
        with the row sums recomputed as rowsum(t) and with them formed from
        the forward's output ``out``."""
        refs = [parts(FA.fused_qkv_attention_bwd_plain(qkv, b_, q_, lse, g, scale, h, out=o,
                                                       seed=sd, dropout_rate=rate))
                for o in (None, out)]
        return held_bwd_both(torch, "K2", tag, parts(got), refs, tol)

    for dtype, n in itertools.product((torch.bfloat16, torch.float32), FUSED_N):
        name = str(dtype)[6:]
        tol = BWD_TOL[name]
        qkv = torch.randn(8, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(8, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        for has_bias, has_qvb, bounded, rate in itertools.product(
                (True, False), (True, False), (True, False), (0.0, 0.1)):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            sd = seed if rate > 0.0 else None
            out, lse = FA.fused_qkv_attention(qkv, b_, q_, sd, scale, h, rate,
                                              bounded_scores=bounded, want_lse=True)
            before = attention_counts(FA)
            got = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h, out=out, seed=sd,
                                             dropout_rate=rate)
            after = attention_counts(FA)
            check(after["K2"] == before["K2"] + 1 and after["K4"] == before["K4"],
                  f"the routed backward at N={n} did not launch K2 once and K4 never")
            check(got[0].dtype == dtype and got[0].shape == qkv.shape, "K2 dqkv dtype/shape")
            tag = (f"{name} N={n} bias={has_bias:d} qv_bias={has_qvb:d} bounded={bounded:d} "
                   f"dropout {rate}")
            abs_err, msg = held(tag, got, qkv, b_, q_, lse, out, g, sd, rate, tol)
            worst, n_cases = max(worst, abs_err), n_cases + 1
            if has_bias and (has_qvb or rate > 0.0):
                print(f"  K2 {tag}: {msg}", flush=True)
            again = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h, out=out, seed=sd,
                                               dropout_rate=rate)
            check(torch.equal(got[0], again[0]), f"K2's dqkv differs between two runs ({tag})")
        del qkv, g, bias, out, got, again
    print(f"  K2: {n_cases} cases within their bounds of both plain versions (the row sums "
          f"recomputed, and formed from the output), dqkv bit-identical between two runs, "
          f"worst max|dqkv-plain| {worst:.3e}", flush=True)

    # ragged tails: the same calls with NaN planted right before and right
    # behind qkv, g, the output and the lse give the same bits
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), FUSED_N):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        out, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=False,
                                          want_lse=True)
        got = FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out)
        f_qkv, f_g, f_lse = fenced(torch, qkv), fenced(torch, g), fenced(torch, lse)
        f_out, f_lse_out = FA.fused_qkv_attention(f_qkv, bias, None, None, scale, h,
                                                  bounded_scores=False, want_lse=True)
        f_got = FA.fused_qkv_attention_bwd(f_qkv, bias, None, f_lse, f_g, scale, h,
                                           out=fenced(torch, out))
        torch.cuda.synchronize()
        check(torch.equal(out, f_out) and torch.equal(lse, f_lse_out),
              f"K1 reads behind the end of qkv ({str(dtype)[6:]} N={n})")
        check(torch.isfinite(f_got[0].float()).all().item() and torch.equal(got[0], f_got[0]),
              f"K2 reads behind the end of qkv, g, out or lse ({str(dtype)[6:]} N={n})")
        check(torch.isfinite(f_got[1]).all().item(), "K2's dbias is not finite behind a NaN fence")
        print(f"  K1/K2 {str(dtype)[6:]} N={n}: NaN planted around qkv, g, out and lse changes no "
              f"bit of out, lse and dqkv", flush=True)
        del qkv, g, bias, got, f_got, f_qkv, f_g

    # the Function (K1 fwd with lse + K2 bwd) against autograd through the
    # plain forward, f32, small N
    for n in (13, 50):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        g = torch.randn(2, n, c, generator=gen, device=dev)
        leaves = [t.clone().requires_grad_() for t in (qkv, bias, qvb)]
        plain_leaves = [t.clone().requires_grad_() for t in (qkv, bias, qvb)]
        f0, b0 = FA.fused_qkv_attention.launches, FA.fused_qkv_attention_bwd.launches
        FA.fused_qkv_attention(*leaves, None, scale, h, bounded_scores=False).backward(g)
        check(FA.fused_qkv_attention.launches == f0 + 1
              and FA.fused_qkv_attention_bwd.launches == b0 + 1,
              "the autograd Function did not launch K1 and K2 once each")
        out, _ = FA.fused_qkv_attention_plain(*plain_leaves, scale, h, bounded_scores=False)
        out.backward(g)
        for name, a, r in zip(("qkv", "bias", "qv_bias"), leaves, plain_leaves):
            rel = _rel_err(a.grad, r.grad)
            print(f"  grad of {name} N={n}: Function vs autograd of plain rel={rel:.3e}",
                  flush=True)
            check(rel <= GRAD_REL_BOUND, f"Function grad of {name} disagrees ({rel:.3e})")

    # the replayed mask itself: zero scores, lse 0 (p = 1) and g = 1 make
    # column j of dv its kept count times 1/(1 - rate), bf16 sums exact in f32
    for n, rate in itertools.product(FUSED_N, (0.1, 0.3)):
        zeros = torch.zeros(8, n, 3 * c, device=dev, dtype=torch.bfloat16)
        ones = torch.ones(8, n, c, device=dev, dtype=torch.bfloat16)
        lse0 = torch.zeros(8, h, n, device=dev)
        got = FA.fused_qkv_attention_bwd(zeros, None, None, lse0, ones, scale, h,
                                         out=torch.zeros_like(ones), seed=seed,
                                         dropout_rate=rate)[0]
        ref = FA.fused_qkv_attention_bwd_plain(zeros, None, None, lse0, ones, scale, h,
                                               out=torch.zeros_like(ones), seed=seed,
                                               dropout_rate=rate)[0]
        check(torch.equal(got[..., 2 * c:], ref[..., 2 * c:]),
              f"K2's replayed dropout mask is not the plain version's (N={n} rate {rate})")
    print(f"  K2 dropout 0.1, 0.3 N={FUSED_N}: zero scores, g = 1: dv equal to the plain "
          f"version's to the bit (the same mask)", flush=True)

    # Euler identity through the Function at rate 0.3 (f32): out is linear in
    # v through the dropped probabilities, so <df/dv, v> = 2f for f =
    # sum(out^2) exactly when K2 replays K1's mask
    for n in (50, 197):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).requires_grad_()
        f0, b0 = FA.fused_qkv_attention.launches, FA.fused_qkv_attention_bwd.launches
        out = FA.fused_qkv_attention(qkv, None, None, seed, scale, h, 0.3, bounded_scores=False)
        f = (out.double() ** 2).sum()
        f.backward()
        check(FA.fused_qkv_attention.launches == f0 + 1
              and FA.fused_qkv_attention_bwd.launches == b0 + 1,
              "the autograd Function with dropout did not launch K1 and K2 once each")
        data = qkv.detach()
        inner = (qkv.grad[..., 2 * c:].double() * data[..., 2 * c:].double()).sum().item()
        rel = abs(inner - 2.0 * f.item()) / (2.0 * f.item())
        # the same backward from another seed than the forward's
        out2, lse = FA.fused_qkv_attention(data, None, None, seed, scale, h, 0.3,
                                           bounded_scores=False, want_lse=True)
        wrong = FA.fused_qkv_attention_bwd(data, None, None, lse, 2.0 * out2, scale, h, out=out2,
                                           seed=seed + 1, dropout_rate=0.3)[0]
        inner_wrong = (wrong[..., 2 * c:].double() * data[..., 2 * c:].double()).sum().item()
        rel_wrong = abs(inner_wrong - 2.0 * f.item()) / (2.0 * f.item())
        print(f"  Euler identity N={n} rate 0.3: |<df/dv, v> - 2f| / 2f = {rel:.3e} with the "
              f"replayed mask, {rel_wrong:.3e} with another seed (bound {EULER_RTOL})", flush=True)
        check(rel <= EULER_RTOL, "K2 does not replay K1's dropout mask")
        check(rel_wrong > EULER_RTOL, "the Euler identity does not tell a wrong mask")

    check(FA.route(BIG_N[0] - 1) == "fused" and FA.route(BIG_N[0]) == "stream",
          "the route does not change kernels right above K2's limit")

    # the model's train shape (ViT-B/16 224: B=160), N=197, bf16, bias, lse of
    # a bounded forward; turns plain, kernel, kernel, plain
    tb = train_b
    qkv = torch.randn(tb, 197, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(tb, 197, c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, 197, 197, generator=gen, device=dev) * 0.5
    out, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=True,
                                      want_lse=True)
    out_d = FA.fused_qkv_attention(qkv, bias, None, seed, scale, h, 0.05, bounded_scores=True)
    kern = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out)
    drop = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out_d,
                                              seed=seed, dropout_rate=0.05)
    plain = lambda: FA.fused_qkv_attention_bwd_plain(qkv, bias, None, lse, g, scale, h, out=out)
    for what, k_fn, rate, o in (("", kern, 0.0, out), (" dropout 0.05", drop, 0.05, out_d)):
        got = k_fn()
        abs_err, msg = held(f"B={tb} N=197{what}", got, qkv, bias, None, lse, o, g,
                            seed if rate else None, rate, BWD_TOL["bfloat16"])
        worst = max(worst, abs_err)
        check(torch.equal(got[0], k_fn()[0]), f"K2's dqkv differs between two runs at B={tb}{what}")
        print(f"  K2 bfloat16 D={d} B={tb} N=197 bias=1{what}: {msg}; dqkv bit-identical between "
              f"two runs", flush=True)
    bound_ms, bound_by = bound(nbytes(qkv, g, lse, bias) + nbytes(qkv, bias),
                               10.0 * tb * h * 197 * 197 * d, "bfloat16")
    del got
    # the library yardstick: autograd's backward of one
    # scaled_dot_product_attention call on the same inputs (dqkv and dbias)
    leaf = qkv.clone().requires_grad_()
    bias_leaf = bias.to(torch.bfloat16).requires_grad_()
    lib_out = sdpa_packed(torch, leaf, bias_leaf, scale, h)
    lib = lambda: torch.autograd.grad(lib_out, (leaf, bias_leaf), g, retain_graph=True)
    no_dbias = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out,
                                                  want_dbias=False)
    best, runs = in_turns({"plain": plain, "kernel": kern, "dropout 0.05": drop,
                           "no dbias": no_dbias, "library": lib}, 10)
    print(f"  K2 at B={tb} N=197 H={h} D={d} bf16 (bias), ms per call: {runs}; bound "
          f"{bound_ms:.4f} ms", flush=True)
    return {"max_abs_err": worst, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
            "other_ms": {f"B={tb} dropout 0.05": best["dropout 0.05"],
                         f"B={tb} no dbias": best["no dbias"]}}


def phase4(torch, FA, dev):
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.train.engine_finetune import (
        FinetuneHParams, init_finetune_state, make_finetune_train_step,
    )
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import cosine_schedule

    FA.BOUNDED_SCORES = True  # bench.py:187, as cli/finetune.py trains
    cfg = get_preset("beit_base_patch16_224", use_shared_rel_pos_bias=True,
                     drop_path_rate=0.1, init_values=0.1)
    gen = torch.Generator(device=dev).manual_seed(2)
    bs = 160
    images = torch.randn(bs, 224, 224, 3, generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
    hp = FinetuneHParams(num_classes=cfg.num_classes)
    lr = cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=500)

    def build(flash: bool, state_dict=None, **overrides):
        c = cfg.replace(use_flash_attention=flash, **overrides)
        model = VisionTransformer(c, dtype=torch.bfloat16, device=dev, generator=gen)
        if state_dict is None:
            # the reference zero-initializes the rel-pos table; draw it so the
            # bias the kernels add and differentiate is not all zeros
            trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
        else:
            model.load_state_dict(state_dict)
        opt = make_optimizer(model, weight_decay=0.05, layer_decay=0.65, depth=c.depth)
        step = make_finetune_train_step(model, opt, hp, lr)
        return model, init_finetune_state(model, opt), step

    model, state, step = build(True)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    plain_model, plain_state, plain_step = build(False, init)
    print(f"  ViT-B/16 224: {sum(p.numel() for p in model.parameters())} params, "
          f"batch {bs}", flush=True)

    def gens(seed):
        return (torch.Generator(device=dev).manual_seed(seed),
                torch.Generator().manual_seed(seed))

    # one step from the same weights and seeds on both attention paths
    m_k = step(state, images, labels, *gens(10))
    m_p = plain_step(plain_state, images, labels, *gens(10))
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
    print(f"  step 0 kernel vs plain attention: loss {loss_k:.6f} / {loss_p:.6f}, "
          f"grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
    check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p), "loss disagrees with plain path")
    check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
          "grad norm disagrees with the plain path")

    # the main path: 3 steps, counts set to 0 just before and read just after
    n_steps = 3
    FA.fused_qkv_attention.launches = 0
    FA.fused_qkv_attention_bwd.launches = 0
    metrics = [step(state, images, labels, *gens(11 + i)) for i in range(n_steps)]
    torch.cuda.synchronize()
    launches = {"fwd": FA.fused_qkv_attention.launches, "bwd": FA.fused_qkv_attention_bwd.launches}
    print(f"  {n_steps} steps: launches {launches}; " + "; ".join(
        f"loss {float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f} "
        f"acc {float(m['class_acc']):.4f} lr {m['lr']:.3e}" for m in metrics), flush=True)
    for k in ("fwd", "bwd"):
        check(launches[k] == cfg.depth * n_steps,
              f"K{1 if k == 'fwd' else 2} launched {launches[k]} times in {n_steps} steps, "
              f"expected {cfg.depth * n_steps}")
    check(all(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
              for m in metrics), "non-finite loss or grad norm")
    moved = 0
    for k, v in model.state_dict().items():
        check(torch.isfinite(v).all().item(), f"non-finite parameter {k}")
        moved += int(not torch.equal(v, init[k]))
    print(f"  parameters changed: {moved} of {len(init)} tensors", flush=True)
    check(moved == len(init), "some parameters did not change")

    rates = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        st, fn = (state, step) if name == "kernel" else (plain_state, plain_step)
        g = gens(20)
        ms = cuda_ms(lambda: fn(st, images, labels, *g), 5)
        rates[name].append(bs * 1000.0 / ms)
    print(f"  train step img/s at batch {bs} (information only): kernel {rates['kernel']}, "
          f"plain attention {rates['plain']}", flush=True)
    del plain_model, plain_state, plain_step

    # one step with attention dropout 0.05 (the cyclical pretraining recipe's
    # rate): K1 draws the mask in the forward, K2 replays it
    drop_model, drop_state, drop_step = build(True, init, attn_drop_rate=0.05)
    drop_state.step = 1  # the warm-up's learning rate is 0 at update 0
    FA.fused_qkv_attention.launches = 0
    FA.fused_qkv_attention_bwd.launches = 0
    m = drop_step(drop_state, images, labels, *gens(30))
    torch.cuda.synchronize()
    drop_launches = {"fwd": FA.fused_qkv_attention.launches,
                     "bwd": FA.fused_qkv_attention_bwd.launches}
    print(f"  1 step with attn_drop_rate=0.05: launches {drop_launches}; loss "
          f"{float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f}", flush=True)
    check(drop_launches == {"fwd": cfg.depth, "bwd": cfg.depth},
          f"the attention-dropout step launched {drop_launches}, expected {cfg.depth} each")
    check(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"])),
          "non-finite loss or grad norm with attention dropout")
    moved = sum(int(not torch.equal(v, init[k])) for k, v in drop_model.state_dict().items())
    check(moved == len(init), "some parameters did not change in the attention-dropout step")
    # the same step from the same weights and seeds with the attention on its
    # plain versions, which draw the masks K1 drew and K2 replayed
    _, ref_state, ref_step = build(True, init, attn_drop_rate=0.05)
    ref_state.step = 1
    with attention_on_plain(torch, FA):
        m_ref = ref_step(ref_state, images, labels, *gens(30))
    torch.cuda.synchronize()
    check(FA.fused_qkv_attention.launches == cfg.depth
          and FA.fused_qkv_attention_bwd.launches == cfg.depth,
          "the plain-attention reference step launched a kernel")
    loss_k, loss_p = float(m["loss"]), float(m_ref["loss"])
    gn_k, gn_p = float(m["grad_norm"]), float(m_ref["grad_norm"])
    print(f"  attention-dropout step, kernels vs plain versions with the same masks: loss "
          f"{loss_k:.6f} / {loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
    check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
          "the attention-dropout step's loss disagrees with the plain versions'")
    check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
          "the attention-dropout step's grad norm disagrees with the plain versions'")
    return launches, drop_launches, rates


# K8's row windows in phase 5: (n tokens, ranks, C, G = K·B folds); C = 5
# takes the element path; (577, 2, 768, 64) is phase 25's fold (K·B = 8·8 at
# ViT-B/16 384); (7, 2, 6, 1) one slab whose rows end inside a 16-byte chunk
WINDOW_CASES = ((577, 2, 768, 16), (577, 2, 768, 64), (5, 2, 768, 6), (5, 2, 5, 6),
                (13, 4, 768, 3), (7, 2, 6, 1))


# K8's batch folds in phase 5: (K copies, b rows a data rank, D data ranks, n
# tokens, C, seq ranks S); (4, 2, 2, 577, 768, 2) is phase 28's MC-dropout
# fold at ViT-B/16 384, C = 5 the element path
FOLD_CASES = ((4, 2, 2, 577, 768, 2), (8, 16, 2, 197, 768, 1), (3, 1, 3, 5, 5, 2),
              (2, 3, 2, 7, 6, 1))


def phase5(torch, dev):
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import philox

    gen = torch.Generator(device=dev).manual_seed(3)
    seed = torch.tensor([0x00C0FFEE12345678], dtype=torch.int64, device=dev)
    base = torch.randn(8 * 197 * 768 + 8, generator=gen, device=dev)
    worst = 0.0
    cases = {"[8*197, 768]": base[:8 * 197 * 768].reshape(8 * 197, 768),
             "[3, 50, 64]": base[:3 * 50 * 64].reshape(3, 50, 64),
             "[1001] ragged": base[:1001],
             "[1001] misaligned": base[1:1002]}
    for dtype, rate in itertools.product((torch.bfloat16, torch.float32), (0.1, 0.5)):
        for name, x in cases.items():
            x = x.to(dtype)
            if "misaligned" in name:  # a contiguous view that starts off a 16-byte boundary
                x = torch.cat([x[:1], x])[1:]
                check(x.data_ptr() % 16 != 0 and x.is_contiguous(), "the view is aligned")
            got = DO.fused_dropout(x, rate, seed)
            ref = DO.fused_dropout_plain(x, rate, seed)
            torch.cuda.synchronize()
            worst = max(worst, (got.float() - ref.float()).abs().max().item())
            kept = (got != 0).float().mean().item()
            print(f"  K8 {str(dtype)[6:]} rate {rate} {name}: equal to the bit "
                  f"{torch.equal(got, ref)}, kept {kept:.4f}", flush=True)
            check(got.dtype == x.dtype and got.shape == x.shape, "K8 dtype/shape")
            check(torch.equal(got, ref), f"K8 differs from its plain version ({name})")
    x = cases["[8*197, 768]"]
    check(DO.fused_dropout(x, 0.0, seed) is x, "K8 at rate 0 does not return x itself")
    check(not torch.equal(DO.fused_dropout(x, 0.1, seed), DO.fused_dropout(x, 0.1, seed + 1)),
          "K8 draws one mask from two seeds")
    for bad in (x.t(), x.to(torch.float16)):
        try:
            DO.fused_dropout(bad, 0.1, seed)
            check(False, "K8 took a tensor it does not support")
        except ValueError:
            pass

    # the row window of sequence parallelism: each rank's rows of a K·B fold
    # draw the unsharded mask's rows; ragged splits of 577 and 5 tokens at C =
    # 768 (the vector path) and C = 5 (element by element)
    for (n, s, c, g), dtype, rate in itertools.product(
            WINDOW_CASES, (torch.bfloat16, torch.float32), (0.1, 0.5)):
        x = torch.randn(g, n, c, generator=gen, device=dev).to(dtype)
        whole = DO.fused_dropout(x, rate, seed)
        for r in range(s):
            start, stop = -(-n // s) * r, min(-(-n // s) * (r + 1), n)
            part = x[:, start:stop].contiguous()
            got = DO.fused_dropout(part, rate, seed, (start, n))
            ref = DO.fused_dropout_plain(part, rate, seed, (start, n))
            torch.cuda.synchronize()
            worst = max(worst, (got.float() - ref.float()).abs().max().item())
            check(torch.equal(got, ref) and torch.equal(got, whole[:, start:stop]),
                  f"K8's window [{start}, {stop}) of {n}, C = {c}, G = {g}, {dtype}, rate {rate}: "
                  "not its plain version's or the unsharded mask's rows")
        print(f"  K8 window {str(dtype)[6:]} rate {rate} [{g}, {n}, {c}] over {s} ranks: equal "
              "to the bit to its plain version and to the unsharded call's rows", flush=True)

    # the batch fold of a data axis: rank d's rows of each of the K copies of a
    # global batch of D·b (local group k·b + i is global k·D·b + d·b + i),
    # under each seq rank's row window, draw one process's rows of the
    # unfolded call
    for (kk, bb, dd, n, c, s), dtype in itertools.product(FOLD_CASES,
                                                         (torch.bfloat16, torch.float32)):
        x = torch.randn(kk * dd * bb, n, c, generator=gen, device=dev).to(dtype)
        whole = DO.fused_dropout(x, 0.3, seed)
        for d, q in itertools.product(range(dd), range(s)):
            fold = (bb, dd * bb, d * bb)
            rows = philox.fold_images(kk * bb, fold).to(dev)
            start, stop = -(-n // s) * q, min(-(-n // s) * (q + 1), n)
            part = x[rows, start:stop].contiguous()
            window = (start, n) if s > 1 else None
            got = DO.fused_dropout(part, 0.3, seed, window, fold)
            ref = DO.fused_dropout_plain(part, 0.3, seed, window, fold)
            torch.cuda.synchronize()
            worst = max(worst, (got.float() - ref.float()).abs().max().item())
            check(torch.equal(got, ref) and torch.equal(got, whole[rows, start:stop]),
                  f"K8's fold {fold} of [{kk * dd * bb}, {n}, {c}] {dtype}, rows [{start}, "
                  f"{stop}): not its plain version's or one process's rows")
        print(f"  K8 fold {str(dtype)[6:]} [{kk}x{dd}x{bb}, {n}, {c}] over {dd} data x {s} seq "
              "ranks: equal to the bit to its plain version and to one process's rows",
              flush=True)

    # the MC-dropout shape: K=8 samples of batch 128 folded, N=197, C=768
    x = torch.randn(1024 * 197, 768, generator=gen, device=dev).to(torch.bfloat16)
    kern = lambda: DO.fused_dropout(x, 0.1, seed)
    plain = lambda: DO.fused_dropout_plain(x, 0.1, seed)
    lib = lambda: torch.nn.functional.dropout(x, 0.1, training=True)
    # the same bytes as rows [197, 394) of a 394-token sequence: the window's
    # index map beside the flat index
    xw = x.view(1024, 197, 768)
    window = lambda: DO.fused_dropout(xw, 0.1, seed, (197, 394))
    # and as data rank 1's 64 rows of each of 16 copies of a global batch of 128:
    # the fold's index map (one division a block) beside the flat index
    fold = lambda: DO.fused_dropout(xw, 0.1, seed, None, (64, 128, 64))
    got, ref = kern(), plain()
    worst = max(worst, (got.float() - ref.float()).abs().max().item())
    check(torch.equal(got, ref), "K8 differs from its plain version at the MC-dropout shape")
    # the window's mask of fold g is a function of g alone: its first 64 folds
    # against the plain version of those folds
    got = window()
    check(torch.equal(got[:64], DO.fused_dropout_plain(xw[:64], 0.1, seed, (197, 394))),
          "K8's window differs from its plain version at [1024, 197 of 394, 768]")
    got = fold()
    check(torch.equal(got[:64], DO.fused_dropout_plain(xw[:64], 0.1, seed, None,
                                                       (64, 128, 64))),
          "K8's fold differs from its plain version at [1024, 197, 768]")
    del got, ref
    best, runs = in_turns({"plain": plain, "kernel": kern, "window": window, "fold": fold,
                           "library": lib}, 10)
    bound_ms, bound_by = bound(2 * nbytes(x), float(x.numel()), "float32")
    print(f"  K8 at [1024*197, 768] bf16 rate 0.1, ms per call: {runs}; bound {bound_ms:.4f} ms",
          flush=True)
    return {"max_abs_err": worst, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
            "window_ms": best["window"], "fold_ms": best["fold"]}


def phase6(torch, FA, dev, det_ms_per_128):
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import (
        evaluate_ensemble, evaluate_mc_dropout,
    )
    from uncertainty_vit_tpu_torch.evals.ensembles import stack_params
    from uncertainty_vit_tpu_torch.evals.mc_dropout import (
        make_mc_dropout_forward, make_mc_dropout_mean_forward,
    )
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO

    FA.BOUNDED_SCORES = True  # cli/finetune.py evaluates with the bounded softmax
    # the MC-dropout bench's setup (tools/bench_mc_dropout.py:72-79): K=8
    # samples of batch 128, drop_rate 0.1, no drop-path, split at block 9
    k, bs, nb, split = 8, 128, 2, 9
    cfg = get_preset("beit_base_patch16_224", use_shared_rel_pos_bias=True, drop_path_rate=0.0,
                     drop_rate=0.1, init_values=0.1)
    gen = torch.Generator(device=dev).manual_seed(4)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    # the head's init std of 0.02 leaves logits of ~1e-2; a wider head makes
    # the samples' spread and the (a)/(b) comparison visible
    trunc_normal(0.1, 2.0)(model.head.weight, gen)
    split_model = VisionTransformer(cfg.replace(dropout_from_block=split), dtype=torch.bfloat16,
                                    device=dev, generator=gen)
    split_model.load_state_dict(model.state_dict())
    images = [torch.randn(bs, 224, 224, 3, generator=gen, device=dev) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]
    batches = list(zip(images, labels))

    def counts():
        return {"K1": FA.fused_qkv_attention.launches, "K2": FA.fused_qkv_attention_bwd.launches,
                "K8": DO.fused_dropout.launches}

    def reset():
        FA.fused_qkv_attention.launches = FA.fused_qkv_attention_bwd.launches = 0
        DO.fused_dropout.launches = 0

    launches = {}
    for name, mdl, split_at, k8_per_fwd in (("folded", model, 0, 2 * cfg.depth),
                                            ("split", split_model, split,
                                             2 * (cfg.depth - split))):
        reset()
        metrics = evaluate_mc_dropout(mdl, batches, num_samples=k, seed=0, split_at=split_at)
        torch.cuda.synchronize()
        launches[name] = counts()
        print(f"  evaluate_mc_dropout {name} (split_at={split_at}): launches {launches[name]}; "
              f"{json.dumps(metrics)}", flush=True)
        check(launches[name] == {"K1": cfg.depth * nb, "K2": 0, "K8": k8_per_fwd * nb},
              f"{name}: launches {launches[name]}, expected K1 {cfg.depth * nb}, K2 0, "
              f"K8 {k8_per_fwd * nb}")
        check(all(math.isfinite(v) for v in metrics.values()), f"{name}: non-finite metric")
        again = evaluate_mc_dropout(mdl, batches, num_samples=k, seed=0, split_at=split_at)
        # the logits are bit-identical from one seed (checked below); the
        # metric sums on the card use atomics, whose order varies
        for key, v in metrics.items():
            check(abs(again[key] - v) <= METRIC_ATOL + METRIC_RTOL * abs(v),
                  f"{name}: {key} is {v} and then {again[key]} from the same seed")

    def dev_gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    x0 = images[0]
    folded = make_mc_dropout_forward(model, k)
    logits = folded(x0, dev_gen(5))
    check(tuple(logits.shape) == (k, bs, cfg.num_classes) and logits.dtype == torch.float32,
          f"MC logits {tuple(logits.shape)} {logits.dtype}")
    check(torch.isfinite(logits).all().item(), "non-finite MC logits")
    spread = (logits - logits.mean(0)).abs().max().item()
    scale = logits.abs().max().item()
    print(f"  folded [K, B, C] logits: max|logit|={scale:.3e}, max|sample - mean|={spread:.3e}",
          flush=True)
    check(all(not torch.equal(logits[0], logits[i]) for i in range(1, k)),
          "MC samples do not differ from one another")
    check(torch.equal(logits, folded(x0, dev_gen(5))),
          "the MC logits are not bit-identical from the same generator seed")
    check(not torch.equal(logits, folded(x0, dev_gen(6))), "another seed gives the same logits")
    # K1 at the folded batch of 1024 inside the model, against the same
    # forward (same seed, K8's masks the same) with the attention on its plain
    # version
    with attention_on_plain(torch, FA):
        ref = folded(x0, dev_gen(5))
    diff = (logits - ref).abs().max().item()
    print(f"  folded forward, K1 vs its plain version: max|diff|={diff:.3e}, ratio "
          f"{diff / ref.abs().max().item():.3e} (bound {LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * ref.abs().max().item(),
          "the folded MC forward disagrees with the same forward on the plain attention")

    # (b) against the folded forward of the same model and seed: exact
    # MC-dropout, since the shared blocks carry no dropout; only the batch the
    # shared blocks' GEMMs run at differs
    split_logits = make_mc_dropout_forward(split_model, k, split_at=split)(x0, dev_gen(7))
    ref = make_mc_dropout_forward(split_model, k)(x0, dev_gen(7))
    diff = (split_logits - ref).abs().max().item()
    ref_scale = ref.abs().max().item()
    print(f"  split-trunk vs folded forward of the same model and seed: max|diff|={diff:.3e}, "
          f"max|logit|={ref_scale:.3e}, ratio {diff / ref_scale:.3e} (bound {LOGIT_REL_BOUND})",
          flush=True)
    check(diff <= LOGIT_REL_BOUND * ref_scale, "the split-trunk forward disagrees with the folded")

    # metrics on the card against a CPU recomputation from the mean logits
    mean_fwd = make_mc_dropout_mean_forward(model, k)
    mean_logits = torch.cat([mean_fwd(x, dev_gen(8 + i)) for i, x in enumerate(images)])
    lab = torch.cat(labels)
    on_card = M.classification_metrics(mean_logits, lab)
    on_cpu = M.classification_metrics(mean_logits.cpu(), lab.cpu())
    for name in on_card:
        a, b = float(on_card[name]), float(on_cpu[name])
        check(abs(a - b) <= METRIC_ATOL + METRIC_RTOL * abs(b),
              f"MC metric {name}: card {a} vs cpu {b}")

    # attention dropout through the model: K1's in-kernel mask
    attn_model = VisionTransformer(cfg.replace(attn_drop_rate=0.1), dtype=torch.bfloat16,
                                   device=dev, generator=gen)
    attn_model.load_state_dict(model.state_dict())
    attn_fwd = make_mc_dropout_forward(attn_model, 2)
    reset()
    a1 = attn_fwd(x0, dev_gen(9))
    launches["attn_drop"] = counts()
    check(launches["attn_drop"] == {"K1": cfg.depth, "K2": 0, "K8": 2 * cfg.depth},
          f"attention-dropout forward: launches {launches['attn_drop']}")
    check(torch.isfinite(a1).all().item() and not torch.equal(a1[0], a1[1]),
          "attention-dropout samples are not finite or do not differ")
    check(torch.equal(a1, attn_fwd(x0, dev_gen(9))),
          "attention-dropout logits are not reproducible from the seed")
    check(not torch.equal(a1, make_mc_dropout_forward(model, 2)(x0, dev_gen(9))),
          "attention dropout 0.1 changes nothing")
    with attention_on_plain(torch, FA):
        a_ref = attn_fwd(x0, dev_gen(9))
    diff = (a1 - a_ref).abs().max().item()
    print(f"  one K=2 forward with attn_drop_rate=0.1: launches {launches['attn_drop']}; K1's "
          f"dropout vs its plain version with the same masks: max|diff|={diff:.3e}, ratio "
          f"{diff / a_ref.abs().max().item():.3e} (bound {LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * a_ref.abs().max().item(),
          "the attention-dropout forward disagrees with the plain attention of the same masks")
    del attn_model

    # a 2-member ensemble at full depth on one batch
    det_cfg = cfg.replace(drop_rate=0.0)
    member = VisionTransformer(det_cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    stacked = stack_params([model.state_dict(), member.state_dict()])
    reset()
    ens = evaluate_ensemble(member, stacked, batches[:1])
    launches["ensemble"] = counts()
    print(f"  evaluate_ensemble (2 members, 1 batch): launches {launches['ensemble']}; ensemble "
          f"{json.dumps(ens['ensemble'])}", flush=True)
    check(launches["ensemble"] == {"K1": 2 * cfg.depth, "K2": 0, "K8": 0},
          f"ensemble launches {launches['ensemble']}")
    check(len(ens["members"]) == 2 and all(
        math.isfinite(v) for m in ens["members"] + [ens["ensemble"]] for v in m.values()),
          "ensemble metrics are not finite")
    check(ens["members"][0] != ens["members"][1], "the two members give the same metrics")
    del member, stacked

    # ms per K*B pass, and its ratio to the deterministic forward at batch 128
    split_fwd = make_mc_dropout_mean_forward(split_model, k, split_at=split)
    g = dev_gen(10)
    best, runs = in_turns({"folded": lambda: mean_fwd(x0, g),
                           "split": lambda: split_fwd(x0, g)}, 3)
    print(f"  MC-dropout K={k} of batch {bs} (information only), ms per K*B pass: {runs}; "
          f"deterministic forward {det_ms_per_128:.2f} ms per {bs}; pass-equivalents: folded "
          f"{best['folded'] / det_ms_per_128:.2f}, split at {split} "
          f"{best['split'] / det_ms_per_128:.2f}; img/s folded {bs * 1000 / best['folded']:.1f}, "
          f"split {bs * 1000 / best['split']:.1f}", flush=True)
    return launches


def attention_counts(FA) -> dict:
    return {"K1": FA.fused_qkv_attention.launches, "K2": FA.fused_qkv_attention_bwd.launches,
            "K3": FA.fused_qkv_attention.stream_launches,
            "K4": FA.fused_qkv_attention_bwd.stream_launches}


def reset_attention_counts(FA) -> None:
    FA.fused_qkv_attention.launches = FA.fused_qkv_attention_bwd.launches = 0
    FA.fused_qkv_attention.stream_launches = FA.fused_qkv_attention_bwd.stream_launches = 0


def plain_fwd_sliced(torch, FA, qkv, bias, qvb, scale, h, bounded, seed, rate, step=4):
    """The forward's plain version `step` images at a time (a [B, H, N, N]
    f32 tensor is 67 MB per image at N=1025, H=16), each slice with the mask
    of its place in the batch."""
    parts = [FA.stream_fwd_plain(qkv[i:i + step], bias, qvb, scale, h, bounded_scores=bounded,
                                 seed=seed, dropout_rate=rate,
                                 fold=slice_fold(i, step, qkv.shape[0]))
             for i in range(0, qkv.shape[0], step)]
    return torch.cat([o for o, _ in parts]), torch.cat([l for _, l in parts])


def plain_bwd_sliced(torch, FA, qkv, bias, qvb, lse, out, g, scale, h, seed, rate, step=2):
    """K4's two plain versions `step` images at a time, the row sums formed
    from the forward's output `out` as the kernel forms them, or with `out`
    None recomputed as rowsum(t) over the keys, as the fused plain backward
    and the JAX kernels form them: (dq, dk, dv, dbias summed over the
    slices, c)."""
    dq, dk, dv, cs, dbias = [], [], [], [], None
    for i in range(0, qkv.shape[0], step):
        sl, fold = slice(i, i + step), slice_fold(i, step, qkv.shape[0])
        dq_i, db_i, c_i = FA.stream_bwd_dq_plain(qkv[sl], bias, qvb, lse[sl], g[sl], scale, h,
                                                 out=None if out is None else out[sl], seed=seed,
                                                 dropout_rate=rate, fold=fold)
        dk_i, dv_i = FA.stream_bwd_dkv_plain(qkv[sl], bias, qvb, lse[sl], c_i, g[sl], scale, h,
                                             seed=seed, dropout_rate=rate, fold=fold)
        dq.append(dq_i), dk.append(dk_i), dv.append(dv_i), cs.append(c_i)
        if db_i is not None:
            dbias = db_i if dbias is None else dbias + db_i
    return torch.cat(dq), torch.cat(dk), torch.cat(dv), dbias, torch.cat(cs)


def phase7(torch, FA, dev, d=64, h=16):
    """K3 at head width d with h heads (ViT-L's 16 x 64 unless given): the
    case grid, then ViT-L/16 512's shapes."""
    gen = torch.Generator(device=dev).manual_seed(7)
    c, scale = h * d, d**-0.5
    seed = torch.tensor([0x0123456789ABCDEF], dtype=torch.int64, device=dev)
    worst, n_cases = 0.0, 0
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), BIG_N):
        name = str(dtype)[6:]
        tol = OUT_TOL[name]
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        check(FA.route(n) == "stream", f"N={n} does not take the streaming route")
        for has_bias, has_qvb, bounded, rate in itertools.product(
                (True, False), (True, False), (True, False), (0.0, 0.1)):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            sd = seed if rate > 0.0 else None
            before = attention_counts(FA)
            out, lse = FA.fused_qkv_attention(qkv, b_, q_, sd, scale, h, rate,
                                              bounded_scores=bounded, want_lse=True)
            out_only = FA.fused_qkv_attention(qkv, b_, q_, sd, scale, h, rate,
                                              bounded_scores=bounded)
            after = attention_counts(FA)
            check(after["K3"] == before["K3"] + 2 and after["K1"] == before["K1"],
                  f"the routed forward at N={n} did not launch K3 twice and K1 never")
            ref, ref_lse = FA.stream_fwd_plain(qkv, b_, q_, scale, h, bounded_scores=bounded,
                                               seed=sd, dropout_rate=rate)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            worst, n_cases = max(worst, err), n_cases + 1
            msg = (f"  K3 {name} N={n} bias={has_bias:d} qv_bias={has_qvb:d} bounded={bounded:d} "
                   f"dropout {rate}: max|out-plain|={err:.3e} max|lse-plain|={lse_err:.3e}")
            check(torch.isfinite(out.float()).all().item(), "K3 output is not finite")
            check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
                  f"K3 output disagrees with the plain version ({msg})")
            check(lse_err <= LSE_ATOL, f"K3 lse disagrees with the plain version ({msg})")
            check(torch.equal(out, out_only), "K3 output depends on want_lse")
            if rate > 0.0:  # the lse is the undropped softmax's, to the bit
                _, lse0 = FA.fused_qkv_attention(qkv, b_, q_, None, scale, h, 0.0,
                                                 bounded_scores=bounded, want_lse=True)
                check(torch.equal(lse, lse0), "K3's lse changes with dropout")
            if has_bias and has_qvb:
                print(msg, flush=True)
        del qkv, bias, out, lse, ref, ref_lse
    print(f"  K3: {n_cases} cases within the K1 tolerances, worst max|out-plain| {worst:.3e}",
          flush=True)

    # the L/512 eval shape: B=16, N=1025, H=16, bf16, bias, bounded scores; the
    # train step gives K3 the first half of it and asks for the lse
    bsz, train_bsz, n = 16, 8, 1025
    qkv = torch.randn(bsz, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    bias_cast = bias.to(torch.bfloat16)
    qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
    fns = {
        "plain": lambda: plain_fwd_sliced(torch, FA, qkv, bias, None, scale, h, True, None, 0.0),
        "kernel": lambda: FA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                                 bounded_scores=True),
        f"train B={train_bsz} with lse": lambda: FA.fused_qkv_attention(
            qkv[:train_bsz], bias, None, None, scale, h, bounded_scores=True, want_lse=True),
        "no bias": lambda: FA.fused_qkv_attention(qkv, None, None, None, scale, h,
                                                  bounded_scores=True),
        "with q/v bias": lambda: FA.fused_qkv_attention(qkv, bias, qvb, None, scale, h,
                                                        bounded_scores=True),
        "with lse": lambda: FA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                                   bounded_scores=True, want_lse=True),
        "dropout 0.1": lambda: FA.fused_qkv_attention(qkv, bias, None, seed, scale, h, 0.1,
                                                      bounded_scores=True),
        "library": lambda: sdpa_packed(torch, qkv, bias_cast, scale, h),
    }
    ref, ref_lse = fns["plain"]()
    ref = ref.float()
    tol = OUT_TOL["bfloat16"]
    got = fns["kernel"]().float()
    err = (got - ref).abs().max().item()
    worst = max(worst, err)
    print(f"  kernel at B={bsz} N={n} H={h} bf16 bias=1 bounded=1: max|out-plain|={err:.3e}",
          flush=True)
    check(torch.allclose(got, ref, atol=tol, rtol=tol),
          f"kernel disagrees with the plain version at the L/512 eval shape ({err:.3e})")
    got, got_lse = fns[f"train B={train_bsz} with lse"]()
    err = (got.float() - ref[:train_bsz]).abs().max().item()
    lse_err = (got_lse - ref_lse[:train_bsz]).abs().max().item()
    worst = max(worst, err)
    print(f"  kernel at the train step's B={train_bsz} with the lse: max|out-plain|={err:.3e} "
          f"max|lse-plain|={lse_err:.3e}", flush=True)
    check(torch.allclose(got.float(), ref[:train_bsz], atol=tol, rtol=tol)
          and lse_err <= LSE_ATOL,
          "K3 disagrees with the plain version at the L/512 train shape")
    del got_lse, ref_lse
    got = fns["dropout 0.1"]().float()
    ref_d = plain_fwd_sliced(torch, FA, qkv, bias, None, scale, h, True, seed, 0.1)[0].float()
    err = (got - ref_d).abs().max().item()
    worst = max(worst, err)
    print(f"  kernel with dropout 0.1 at the same shape: max|out-plain|={err:.3e}", flush=True)
    check(torch.allclose(got, ref_d, atol=tol, rtol=tol),
          "K3 with dropout disagrees with the plain version at the L/512 eval shape")
    del got, ref, ref_d
    best, runs = in_turns(fns, 10)
    print(f"  K3 at B={bsz} N={n} H={h} D={d} bf16 (bias, bounded), ms per call: {runs}",
          flush=True)
    bound_ms, bound_by = bound(nbytes(qkv, bias) + qkv.numel() // 3 * 2,
                               4.0 * bsz * h * n * n * d, "bfloat16")
    return {"max_abs_err": worst, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
            "other_ms": {k: best[k] for k in (f"train B={train_bsz} with lse", "no bias",
                                              "with q/v bias", "with lse", "dropout 0.1")}}


def held_bwd_both(torch, kernel, tag, got, refs, tol):
    """``held_bwd`` against each of the two plain references in ``refs``:
    first the row sums recomputed as rowsum(t) (the function, as the JAX
    kernels form it), then the row sums formed from the forward's output
    (g·o, as the kernel forms them). Returns the larger absolute error and
    the first reference's summary."""
    first = held_bwd(torch, kernel, f"{tag}, c recomputed", got, refs[0], tol)
    second = held_bwd(torch, kernel, f"{tag}, c from the output", got, refs[1], tol)
    return max(first[0], second[0]), first[1]


def held_bwd(torch, kernel, tag, got, ref, tol):
    """got = (dq, dk, dv, dbias, dqvb) of a streaming backward (K4 or K5),
    ref the same of its plain versions; each part against its bound in
    ``tol`` relative to max|plain|. Returns (the largest absolute error of
    dq, dk and dv, a summary)."""
    names = ("dq", "dk", "dv", "dbias", "dqvb")
    check((got[3] is None) == (ref[3] is None), f"{kernel} dbias presence differs ({tag})")
    msg, abs_err = [], 0.0
    for name, a, r in zip(names, got, ref):
        if a is None:
            continue
        check(torch.isfinite(a.float()).all().item(), f"{kernel} {name} is not finite ({tag})")
        rel = _rel_err(a, r)
        if name in ("dq", "dk", "dv"):
            abs_err = max(abs_err, (a.float() - r.float()).abs().max().item())
        msg.append(f"{name} rel={rel:.3e}")
        bound_ = tol["dqkv" if name in ("dq", "dk", "dv") else name]
        check(rel <= bound_, f"{kernel} {name} disagrees with its plain version ({tag}: rel "
              f"{rel:.3e} > {bound_})")
    if got[4] is not None:
        check(torch.all(got[4][1] == 0).item(), f"{kernel} dqvb has a nonzero k row ({tag})")
    return abs_err, ", ".join(msg)


def phase8(torch, FA, dev, d=64, h=16):
    """K4 at head width d with h heads (ViT-L's 16 x 64 unless given): the
    case grid and its checks, then ViT-L/16 512's train shape."""
    gen = torch.Generator(device=dev).manual_seed(8)
    c, scale = h * d, d**-0.5
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64, device=dev)
    worst, n_cases = 0.0, 0

    def held(tag, got, qkv, b_, q_, lse, out, g, sd, rate, tol):
        """got = (dqkv, dbias, dqvb) of the routed call, held against the two
        plain versions (``plain_bwd_sliced``) with the row sums recomputed
        and with them formed from the forward's output ``out``."""
        dqkv, dbias, dqvb = got
        refs = []
        for o in (None, out):
            ref = plain_bwd_sliced(torch, FA, qkv, b_, q_, lse, o, g, scale, h, sd, rate)
            ref_dqvb = (FA.reduce_qv_bias_grad(torch.cat(ref[:3], dim=-1)) if dqvb is not None
                        else None)
            refs.append((*ref[:4], ref_dqvb))
        return held_bwd_both(torch, "K4", tag, (*dqkv.chunk(3, dim=-1), dbias, dqvb), refs, tol)

    for dtype, n in itertools.product((torch.bfloat16, torch.float32), BIG_N):
        name = str(dtype)[6:]
        tol = BWD_TOL[name]
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        for has_bias, has_qvb, bounded, rate in itertools.product(
                (True, False), (True, False), (True, False), (0.0, 0.1)):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            sd = seed if rate > 0.0 else None
            out, lse = FA.fused_qkv_attention(qkv, b_, q_, sd, scale, h, rate,
                                              bounded_scores=bounded, want_lse=True)
            before = attention_counts(FA)
            got = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h, out=out, seed=sd,
                                             dropout_rate=rate)
            after = attention_counts(FA)
            check(after["K4"] == before["K4"] + 1 and after["K2"] == before["K2"],
                  f"the routed backward at N={n} did not launch K4 once and K2 never")
            tag = (f"{name} N={n} bias={has_bias:d} qv_bias={has_qvb:d} bounded={bounded:d} "
                   f"dropout {rate}")
            check(got[0].dtype == dtype and got[0].shape == qkv.shape, "K4 dqkv dtype/shape")
            abs_err, msg = held(tag, got, qkv, b_, q_, lse, out, g, sd, rate, tol)
            worst, n_cases = max(worst, abs_err), n_cases + 1
            if has_bias and has_qvb:
                print(f"  K4 {tag}: {msg}", flush=True)
            again = FA.fused_qkv_attention_bwd(qkv, b_, q_, lse, g, scale, h, out=out, seed=sd,
                                               dropout_rate=rate)
            check(torch.equal(got[0], again[0]), f"K4's dqkv differs between two runs ({tag})")
        del qkv, g, bias, out, got, again
    print(f"  K4: {n_cases} cases within K2's bounds of both plain versions (the row sums "
          f"recomputed, and formed from the output), dqkv bit-identical between two runs, "
          f"worst max|dqkv-plain| {worst:.3e}", flush=True)

    # ragged tails feed dk and dv: the same call with NaN planted right before
    # and right behind qkv, g, the output and the lse gives the same bits
    for dtype, n in itertools.product((torch.bfloat16, torch.float32), (577, 1025)):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5

        out, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=False,
                                          want_lse=True)
        got = FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out)
        f_qkv, f_g, f_lse = fenced(torch, qkv), fenced(torch, g), fenced(torch, lse)
        f_out, f_lse_out = FA.fused_qkv_attention(f_qkv, bias, None, None, scale, h,
                                                  bounded_scores=False, want_lse=True)
        f_got = FA.fused_qkv_attention_bwd(f_qkv, bias, None, f_lse, f_g, scale, h,
                                           out=fenced(torch, out))
        torch.cuda.synchronize()
        check(torch.equal(out, f_out) and torch.equal(lse, f_lse_out),
              f"K3 reads behind the end of qkv ({str(dtype)[6:]} N={n})")
        check(torch.isfinite(f_got[0].float()).all().item() and torch.equal(got[0], f_got[0]),
              f"K4 reads behind the end of qkv, g, out or lse ({str(dtype)[6:]} N={n})")
        check(torch.isfinite(f_got[1]).all().item(), "K4's dbias is not finite behind a NaN fence")
        print(f"  K3/K4 {str(dtype)[6:]} N={n}: NaN planted around qkv, g, out and lse changes no "
              f"bit of out, lse and dqkv", flush=True)
        del qkv, g, bias, got, f_got, f_qkv, f_g

    # the Function through the streaming route (K3 + K4, f32) against autograd
    # through the plain forward
    n = 257
    qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
    g = torch.randn(2, n, c, generator=gen, device=dev)
    leaves = [t.clone().requires_grad_() for t in (qkv, bias, qvb)]
    plain_leaves = [t.clone().requires_grad_() for t in (qkv, bias, qvb)]
    before = attention_counts(FA)
    FA.fused_qkv_attention(*leaves, None, scale, h, bounded_scores=False).backward(g)
    after = attention_counts(FA)
    check({k: after[k] - before[k] for k in after} == {"K1": 0, "K2": 0, "K3": 1, "K4": 1},
          "the autograd Function at N=257 did not launch K3 and K4 once each")
    out, _ = FA.stream_fwd_plain(*plain_leaves, scale, h, bounded_scores=False)
    out.backward(g)
    for name, a, r in zip(("qkv", "bias", "qv_bias"), leaves, plain_leaves):
        rel = _rel_err(a.grad, r.grad)
        print(f"  grad of {name} N={n}: Function (K3 + K4) vs autograd of plain rel={rel:.3e}",
              flush=True)
        check(rel <= GRAD_REL_BOUND, f"Function grad of {name} disagrees at N={n} ({rel:.3e})")
    del leaves, plain_leaves, out

    # Euler identity through the Function at rate 0.3 (f32): <df/dv, v> = 2f
    # for f = sum(out^2) exactly when K4's two kernels replay K3's mask
    for n in (257, 577):
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).requires_grad_()
        out = FA.fused_qkv_attention(qkv, None, None, seed, scale, h, 0.3, bounded_scores=False)
        f = (out.double() ** 2).sum()
        f.backward()
        data = qkv.detach()
        inner = (qkv.grad[..., 2 * c:].double() * data[..., 2 * c:].double()).sum().item()
        rel = abs(inner - 2.0 * f.item()) / (2.0 * f.item())
        out2, lse = FA.fused_qkv_attention(data, None, None, seed, scale, h, 0.3,
                                           bounded_scores=False, want_lse=True)
        wrong = FA.fused_qkv_attention_bwd(data, None, None, lse, 2.0 * out2, scale, h, out=out2,
                                           seed=seed + 1, dropout_rate=0.3)[0]
        inner_wrong = (wrong[..., 2 * c:].double() * data[..., 2 * c:].double()).sum().item()
        rel_wrong = abs(inner_wrong - 2.0 * f.item()) / (2.0 * f.item())
        print(f"  Euler identity N={n} rate 0.3: |<df/dv, v> - 2f| / 2f = {rel:.3e} with the "
              f"replayed mask, {rel_wrong:.3e} with another seed (bound {EULER_RTOL})", flush=True)
        check(rel <= EULER_RTOL, "K4 does not replay K3's dropout mask")
        check(rel_wrong > EULER_RTOL, "the Euler identity does not tell a wrong mask")
        del qkv, out, out2, wrong

    # the L/512 train shape: B=8, N=1025, H=16, bf16, bias, lse of a bounded
    # forward
    bsz, n = 8, 1025
    qkv = torch.randn(bsz, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(bsz, n, c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    out, lse = FA.fused_qkv_attention(qkv, bias, None, None, scale, h, bounded_scores=True,
                                      want_lse=True)
    out_d = FA.fused_qkv_attention(qkv, bias, None, seed, scale, h, 0.05, bounded_scores=True)
    qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
    out_q, lse_q = FA.fused_qkv_attention(qkv, bias, qvb, None, scale, h, bounded_scores=True,
                                          want_lse=True)
    kern = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out)
    no_dbias = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out,
                                                  want_dbias=False)
    drop = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse, g, scale, h, out=out_d,
                                              seed=seed, dropout_rate=0.05)
    with_qvb = lambda: FA.fused_qkv_attention_bwd(qkv, bias, qvb, lse_q, g, scale, h, out=out_q)
    plain = lambda: plain_bwd_sliced(torch, FA, qkv, bias, None, lse, out, g, scale, h, None,
                                     0.0)
    for what, k_fn, rate, o in (("", kern, 0.0, out), (" dropout 0.05", drop, 0.05, out_d)):
        abs_err, msg = held(f"B={bsz} N={n}{what}", k_fn(), qkv, bias, None, lse, o, g,
                            seed if rate else None, rate, BWD_TOL["bfloat16"])
        worst = max(worst, abs_err)
        print(f"  K4 bfloat16 B={bsz} N={n} bias=1{what}: {msg}", flush=True)
    # the function's own traffic: the output the kernel reads for its row
    # sums is this design's, not the function's
    bound_ms, bound_by = bound(nbytes(qkv, g, lse, bias) + nbytes(qkv, bias),
                               10.0 * bsz * h * n * n * d, "bfloat16")
    # the library yardstick: autograd's backward of one
    # scaled_dot_product_attention call on the same inputs (dqkv and dbias)
    leaf = qkv.clone().requires_grad_()
    bias_leaf = bias.to(torch.bfloat16).requires_grad_()
    lib_out = sdpa_packed(torch, leaf, bias_leaf, scale, h)
    lib = lambda: torch.autograd.grad(lib_out, (leaf, bias_leaf), g, retain_graph=True)
    best, runs = in_turns({"plain": plain, "kernel": kern, "no dbias": no_dbias,
                           "with q/v bias": with_qvb, "dropout 0.05": drop, "library": lib}, 5)
    print(f"  K4 at B={bsz} N={n} H={h} D={d} bf16 (bias), ms per call: {runs}", flush=True)
    return {"max_abs_err": worst, "ms": best["kernel"], "plain_ms": best["plain"],
            "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
            "other_ms": {k: best[k] for k in ("no dbias", "with q/v bias", "dropout 0.05")}}


def host_ms(torch, fn) -> float:
    """ms of one call of fn on the host clock, the device synchronized before
    and after."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def large_512_model(torch, dev, init, group=None, train=False, preset="beit_large_patch16_512",
                    **overrides):
    """Phase 9's ViT-L/16 512 (phase 13's ViT-H/16 224 with
    preset="beit_huge_patch16_224"; shared rel-pos bias, layer scale 0.1,
    bf16 on f32 parameters, config ``overrides``) on the state ``init``, its tokens
    split over ``group`` when one is given: (model, None, None) for
    evaluation; for training, with drop-path 0.1, (model, state, step) with
    phase 9's step (batch mixup, AdamW with layer decay 0.75 and weight decay
    0.05 on a cosine LR), the state halfway up the warm-up (lr 2e-3: at its
    start lr times block 0's layer-decay scale 0.75^24 is below half an ulp
    of a LayerNorm weight of 1, and those weights would not move)."""
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.train.engine_finetune import (
        FinetuneHParams, init_finetune_state, make_finetune_train_step,
    )
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import cosine_schedule

    cfg = get_preset(preset, use_shared_rel_pos_bias=True, init_values=0.1,
                     drop_path_rate=0.1 if train else 0.0, **overrides)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, seq_group=group,
                              generator=torch.Generator(device=dev).manual_seed(0))
    model.load_state_dict(init)
    if not train:
        return model, None, None
    opt = make_optimizer(model, weight_decay=0.05, layer_decay=0.75, depth=cfg.depth)
    state = init_finetune_state(model, opt)
    state.step = 250
    step = make_finetune_train_step(model, opt, FinetuneHParams(num_classes=cfg.num_classes),
                                    cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=500))
    return model, state, step


def large_512_gens(torch, dev, seed):
    """(the device generator of drop-path, the CPU generator of mixup) of a
    step, both from ``seed``."""
    return torch.Generator(device=dev).manual_seed(seed), torch.Generator().manual_seed(seed)


def phase9(torch, FA, dev):
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.evals.mc_dropout import make_mc_dropout_forward
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )
    from uncertainty_vit_tpu_torch.utils.checkpoint import resize_state_dict

    FA.BOUNDED_SCORES = True  # as cli/finetune.py trains and evaluates
    kw = dict(use_shared_rel_pos_bias=True, init_values=0.1)
    cfg = get_preset("beit_large_patch16_512", **kw)
    n = cfg.num_patches + 1
    check(FA.route(n) == "stream" and n == 1025, f"L/512 has N={n} on route {FA.route(n)}")
    gen = torch.Generator(device=dev).manual_seed(9)

    # the weights a 512 finetune starts from: a 224 model of the same width,
    # its rel-pos table (drawn at std 0.2 so that the bias is not all zeros)
    # carried from the 14 x 14 to the 32 x 32 window
    low = VisionTransformer(get_preset("beit_large_patch16_224", **kw), dtype=torch.bfloat16,
                            device=dev, generator=gen)
    trunc_normal(0.2, 2.0)(low.rel_pos_bias.relative_position_bias_table, gen)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    init = resize_state_dict(low.state_dict(), model)
    model.load_state_dict(init, strict=True)
    table = model.rel_pos_bias.relative_position_bias_table
    check(tuple(table.shape) == ((2 * 32 - 1) ** 2 + 3, cfg.num_heads)
          and torch.isfinite(table).all().item() and table.abs().max().item() > 0.1,
          "the interpolated rel-pos table is not what the 32 x 32 window needs")
    check(torch.equal(table[-3:], low.rel_pos_bias.relative_position_bias_table[-3:]),
          "the cls entries of the rel-pos table did not pass through")
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  ViT-L/16 512: {n_params} params, depth {cfg.depth}, width {cfg.embed_dim}, "
          f"{cfg.num_heads} heads, N={n}; rel-pos table interpolated from the 224 model's "
          f"{tuple(low.rel_pos_bias.relative_position_bias_table.shape)} to {tuple(table.shape)}",
          flush=True)
    del low

    def counts():
        return {**attention_counts(FA), "K8": DO.fused_dropout.launches}

    def reset():
        reset_attention_counts(FA)
        DO.fused_dropout.launches = 0

    # --- evaluate(): 2 batches of 16 uint8 images
    bs, nb = 16, 2
    images = [torch.randint(0, 256, (bs, 512, 512, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]

    def batches():
        for u8, lbl in zip(images, labels):
            yield normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD), lbl

    torch.cuda.reset_peak_memory_stats()
    reset()
    metrics = evaluate(model, batches())
    torch.cuda.synchronize()
    launches = {"evaluate": counts()}
    peak_eval = torch.cuda.max_memory_allocated() / 2**30
    print(f"  evaluate(): launches {launches['evaluate']}; {json.dumps(metrics)}", flush=True)
    check(launches["evaluate"] == {"K1": 0, "K2": 0, "K3": cfg.depth * nb, "K4": 0, "K8": 0},
          f"evaluate() launched {launches['evaluate']}, expected K3 {cfg.depth * nb} only")
    check(all(math.isfinite(v) for v in metrics.values()), "non-finite metric")
    fwd = make_eval_forward(model)
    x0 = next(batches())[0]
    logits = torch.cat([fwd(x) for x, _ in batches()])
    check(tuple(logits.shape) == (bs * nb, cfg.num_classes) and logits.dtype == torch.float32
          and torch.isfinite(logits).all().item(), "L/512 logits are not finite f32 [32, 1000]")
    with attention_on_plain(torch, FA):
        ref = fwd(x0)
    diff = (logits[:bs] - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"  logits K3 vs plain attention: max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio "
          f"{diff / scale:.3e} (bound {LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * scale, "L/512 logits disagree with the plain attention")
    # metrics on the card against a CPU recomputation, on well-separated
    # seeded logits (the random model's logits are within ~1e-3 of each other)
    lab = torch.cat(labels)
    syn = torch.randn(bs * nb, cfg.num_classes, generator=gen, device=dev) * 2.0
    syn[torch.arange(bs * nb, device=dev), lab] += 2.0
    on_card, on_cpu = M.classification_metrics(syn, lab), M.classification_metrics(syn.cpu(),
                                                                                   lab.cpu())
    for k in on_card:
        a, b = float(on_card[k]), float(on_cpu[k])
        check(abs(a - b) <= METRIC_ATOL + METRIC_RTOL * abs(b), f"metric {k}: card {a} vs cpu {b}")
    eval_ms = [cuda_ms(lambda: fwd(x0), 3) for _ in range(2)]
    print(f"  eval forward at batch {bs} (information only): {[bs * 1000 / ms for ms in eval_ms]} "
          f"img/s; peak memory of evaluate() {peak_eval:.2f} GiB", flush=True)
    del logits, ref, images

    # --- the finetune train step
    def build(**overrides):
        return large_512_model(torch, dev, init, train=True, **overrides)

    def gens(seed):
        return large_512_gens(torch, dev, seed)

    def step_counts(depth_steps):
        return {"K1": 0, "K2": 0, "K3": depth_steps, "K4": depth_steps, "K8": 0}

    bs_t, n_steps = 8, 3
    x = torch.randn(bs_t, 512, 512, 3, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (bs_t,), generator=gen, device=dev)
    tmodel, state, step = build()
    torch.cuda.reset_peak_memory_stats()
    reset()
    ms = [step(state, x, y, *gens(11 + i)) for i in range(n_steps)]
    torch.cuda.synchronize()
    launches["train_step"] = counts()
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {n_steps} steps at batch {bs_t}: launches {launches['train_step']}; " + "; ".join(
        f"loss {float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f}" for m in ms),
        flush=True)
    check(launches["train_step"] == step_counts(cfg.depth * n_steps),
          f"{n_steps} train steps launched {launches['train_step']}")
    check(all(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
              for m in ms), "non-finite loss or grad norm")
    moved = 0
    for k, v in tmodel.state_dict().items():
        check(torch.isfinite(v).all().item(), f"non-finite parameter {k}")
        moved += int(not torch.equal(v, init[k]))
    check(moved == len(init), f"only {moved} of {len(init)} parameter tensors changed")
    g = gens(20)
    train_ms = [cuda_ms(lambda: step(state, x, y, *g), 3) for _ in range(2)]
    print(f"  train step at batch {bs_t} (information only): "
          f"{[bs_t * 1000 / ms for ms in train_ms]} img/s; peak memory of the {n_steps} steps "
          f"{peak_train:.2f} GiB; all {moved} parameter tensors changed", flush=True)
    del tmodel, state, step

    # one step at batch 2 (the plain path saves [B, H, N, N] f32 tensors per
    # layer) from the same weights and seeds, kernels against plain versions
    x2, y2 = x[:2], y[:2]
    for what, overrides, seed in (("", {}, 30), (" with attn_drop_rate=0.05",
                                                 {"attn_drop_rate": 0.05}, 31)):
        _, st_k, step_k = build(**overrides)
        reset()
        m_k = step_k(st_k, x2, y2, *gens(seed))
        torch.cuda.synchronize()
        key = "train_step_attn_drop" if overrides else "train_step_batch_2"
        launches[key] = counts()
        check(launches[key] == step_counts(cfg.depth), f"the step{what} launched {launches[key]}")
        del st_k, step_k
        _, st_p, step_p = build(**overrides)
        with attention_on_plain(torch, FA):
            m_p = step_p(st_p, x2, y2, *gens(seed))
        torch.cuda.synchronize()
        check(counts() == launches[key], "the plain-attention reference step launched a kernel")
        del st_p, step_p
        loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
        gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
        print(f"  one step at batch 2{what}, K3/K4 vs their plain versions: loss {loss_k:.6f} / "
              f"{loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
        check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
              f"the L/512 step's loss{what} disagrees with the plain versions'")
        check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
              f"the L/512 step's grad norm{what} disagrees with the plain versions'")

    # --- one K=2 MC forward with attention dropout 0.1: K3's in-kernel mask
    mc_model = VisionTransformer(cfg.replace(attn_drop_rate=0.1), dtype=torch.bfloat16,
                                 device=dev, generator=gen)
    mc_model.load_state_dict(init)
    trunc_normal(0.1, 2.0)(mc_model.head.weight, gen)  # a wider head: the samples spread
    mc_fwd = make_mc_dropout_forward(mc_model, 2)
    xm = x[:4]
    reset()
    a1 = mc_fwd(xm, torch.Generator(device=dev).manual_seed(40))
    launches["mc_attn_drop"] = counts()
    check(launches["mc_attn_drop"] == {"K1": 0, "K2": 0, "K3": cfg.depth, "K4": 0, "K8": 0},
          f"the attention-dropout MC forward launched {launches['mc_attn_drop']}")
    check(tuple(a1.shape) == (2, 4, cfg.num_classes) and torch.isfinite(a1).all().item()
          and not torch.equal(a1[0], a1[1]), "MC samples are not finite or do not differ")
    check(torch.equal(a1, mc_fwd(xm, torch.Generator(device=dev).manual_seed(40))),
          "the MC logits are not reproducible from the seed")
    with attention_on_plain(torch, FA):
        a_ref = mc_fwd(xm, torch.Generator(device=dev).manual_seed(40))
    diff = (a1 - a_ref).abs().max().item()
    print(f"  one K=2 forward of batch 4 with attn_drop_rate=0.1: launches "
          f"{launches['mc_attn_drop']}; K3's dropout vs its plain version with the same masks: "
          f"max|diff|={diff:.3e}, ratio {diff / a_ref.abs().max().item():.3e} (bound "
          f"{LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * a_ref.abs().max().item(),
          "the L/512 attention-dropout forward disagrees with the plain attention of the "
          "same masks")
    return launches, init


# The trunk's dense layers as (K, N) = (in, out): ViT-B's qkv, proj, fc1, fc2
# and ViT-L's. The forward runs (K, N), the dgrad (N, K).
TRUNK_B = {"qkv": (768, 2304), "proj": (768, 768), "fc1": (768, 3072), "fc2": (3072, 768)}
TRUNK_L = {"qkv": (1024, 3072), "proj": (1024, 1024), "fc1": (1024, 4096), "fc2": (4096, 1024)}
TRUNK_H = {"qkv": (1280, 3840), "proj": (1280, 1280), "fc1": (1280, 5120), "fc2": (5120, 1280)}
# (K, N) past every trunk: beit_huge_patch16_224's fc2 contraction, and one
# past the 6,272 that K6 took before it streamed the contraction.
WIDE_K = ((5120, 1280), (6400, 384))
# Tokens of the ViT-B/16 224 train step at batch 160 (ragged against 64: 492 * 64 + 32)
# and of its eval forward at batch 128 (394 * 64).
M_TRAIN = 160 * 197
M_EVAL = 128 * 197
# Tokens of the ViT-H/16 224 train step at batch 32 (98.5 row tiles of 64).
M_HUGE = 32 * 197
# Row windows (rows, start, n, image0 = 0) of seq shards: ViT-B/16 384's N = 577 over two
# ranks (289 | 288), ViT-L/16 512's 1025 (513 | 512), a window of 3 rows of 7,
# and one of 98 of ViT-B/16 224's 197 tokens at 320 images (31,360 rows: the
# window's time beside the unwindowed call on the same rows), each with its
# image count.
QUANT_WINDOWS = (((289, 0, 577), 8), ((288, 289, 577), 8), ((513, 0, 1025), 4),
                 ((512, 513, 1025), 4), ((3, 2, 7), 5))
TIMED_WINDOW = ((98, 99, 197, 0), 320)


def fenced(torch, t):
    """A copy of t with NaN planted right before and right behind it."""
    buf = torch.full((t.numel() + 256,), float("nan"), dtype=t.dtype, device=t.device)
    view = buf[128:128 + t.numel()].view(t.shape)
    view.copy_(t)
    check(view.data_ptr() % 16 == 0 and torch.isnan(buf[:128].float()).all().item()
          and torch.isnan(buf[-128:].float()).all().item(), "the NaN fence is not there")
    return view


def quant_shapes():
    """Every (K, N) the int8 kernels meet in ViT-B and ViT-L, forward and
    dgrad, once each."""
    shapes = []
    for k, n in list(TRUNK_B.values()) + list(TRUNK_L.values()):
        for pair in ((k, n), (n, k)):
            if pair not in shapes:
                shapes.append(pair)
    return shapes


def phase10(torch, dev):
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    gen = torch.Generator(device=dev).manual_seed(10)
    seed = torch.tensor([0x0123456789ABCDEF], dtype=torch.int64, device=dev)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    unequal = n_cases = 0

    def held(tag, x, wq, ws, bias, sr, dtype, window=None):
        nonlocal unequal, n_cases
        name = str(dtype)[6:]
        before = TQ.qmm.launches
        got = TQ.qmm(x, wq, ws, bias, seed, sr, dtype, window)
        check(TQ.qmm.launches == before + 1, "qmm did not launch K6 once")
        ref = TQ.qmm_plain(x, wq, ws, bias, seed, sr, dtype, window)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == ref.shape, f"K6 dtype/shape ({tag})")
        check(torch.isfinite(got.float()).all().item(), f"K6 output is not finite ({tag})")
        rel = ((got.float() - ref.float()).abs() / ref.float().abs().clamp_min(1e-30)).max().item()
        rel = 0.0 if torch.equal(got, ref) else rel
        worst[name] = max(worst[name], rel)
        unequal += int(not torch.equal(got, ref))
        n_cases += 1
        check(rel <= QMM_REL_TOL[name], f"K6 disagrees with its plain version ({tag}: worst "
              f"relative difference {rel:.3e} > {QMM_REL_TOL[name]})")
        return (got.float() - ref.float()).abs().max().item()

    worst_abs = 0.0
    for dtype, (k, n) in itertools.product((torch.bfloat16, torch.float32), quant_shapes()):
        w = torch.randn(n, k, generator=gen, device=dev) * 0.05
        wq, ws = TQ.quantize_cols(w.t())
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        for m in (8, 197, 1000):  # 1000 = 15 * 64 + 40: ragged against every row tile
            x = fenced(torch, torch.randn(m, k, generator=gen, device=dev).to(dtype))
            for sr, has_bias in itertools.product((False, True), (True, False)):
                tag = f"{str(dtype)[6:]} M={m} K={k} N={n} sr={sr:d} bias={has_bias:d}"
                worst_abs = max(worst_abs, held(tag, x, wq, ws, bias if has_bias else None, sr,
                                                dtype))
        del w, wq
    print(f"  K6: {n_cases} cases (bf16/f32 x {len(quant_shapes())} shapes x M 8/197/1000 x "
          f"nearest/stochastic x bias/none, NaN planted around x): {unequal} not equal to the "
          f"bit, worst relative difference bf16 {worst['bfloat16']:.3e} / f32 "
          f"{worst['float32']:.3e}", flush=True)
    # contractions wider than any trunk's (the reference admits every multiple
    # of 128), and a walk of the persistent tiles that wraps with a ragged
    # last row tile (3333 = 26 * 128 + 5 rows; 27 x 5 tiles of 128 x 256)
    before = (n_cases, unequal)
    for dtype, (k, n), m in itertools.product((torch.bfloat16, torch.float32), WIDE_K,
                                              (8, 197, 1000)):
        w = torch.randn(n, k, generator=gen, device=dev) * 0.05
        wq, ws = TQ.quantize_cols(w.t())
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        x = fenced(torch, torch.randn(m, k, generator=gen, device=dev).to(dtype))
        for sr, has_bias in itertools.product((False, True), (True, False)):
            tag = f"{str(dtype)[6:]} M={m} K={k} N={n} sr={sr:d} bias={has_bias:d}"
            worst_abs = max(worst_abs, held(tag, x, wq, ws, bias if has_bias else None, sr,
                                            dtype))
    k, n, m = 5120, 1280, 3333
    w = torch.randn(n, k, generator=gen, device=dev) * 0.05
    wq, ws = TQ.quantize_cols(w.t())
    bias = torch.randn(n, generator=gen, device=dev) * 0.1
    x = fenced(torch, torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16))
    for sr in (False, True):
        worst_abs = max(worst_abs, held(f"ragged walk M={m} K={k} N={n} sr={sr:d}", x, wq, ws,
                                        None if sr else bias, sr, torch.bfloat16))
    print(f"  K6 at K = {', '.join(str(k) for k, _ in WIDE_K)} (bf16/f32 x M 8/197/1000 x "
          f"nearest/stochastic x bias/none) and M={m} K={k} N={n}: {n_cases - before[0]} cases, "
          f"{unequal - before[1]} not equal to the bit", flush=True)
    # the dgrad's second int8 copy of a weight is transposed once by the wrapper
    w = torch.randn(768, 2304, generator=gen, device=dev) * 0.05
    wq, ws = TQ.quantize_cols(w)  # [K, N] row-major: not the kernel's layout
    x = torch.randn(197, 768, generator=gen, device=dev).to(torch.bfloat16)
    check(not wq.t().is_contiguous(), "the test weight already lies as the kernel reads it")
    worst_abs = max(worst_abs, held("transposed copy", x, wq, ws, None, True, torch.bfloat16))
    for bad_x, bad_w in ((x.to(torch.float16), wq), (x[:4], wq), (x[:, :600], wq[:600])):
        try:
            TQ.qmm(bad_x, bad_w, ws, None, seed, False, torch.bfloat16)
            check(False, "K6 took a tensor it does not support")
        except ValueError:
            pass
    del w, wq, x

    # the train step's shapes: M = 31,520, bf16; forward (nearest, bias) and
    # dgrad (stochastic, K and N swapped, no bias)
    def int_mm_library(x, wq_t, ws, bias):
        """The library yardstick: torch._int_mm between plain PyTorch passes
        that quantize the rows and dequantize the result (nearest rounding).
        Timed here and used nowhere in the port."""
        xf = x.float()
        amax = xf.abs().amax(dim=1, keepdim=True)
        xq = torch.round(xf * (127.0 / amax.clamp_min(1e-30))).to(torch.int8)
        y = torch._int_mm(xq, wq_t.t()).float() * (amax * (1.0 / 127.0)) * ws
        return (y if bias is None else y + bias).to(x.dtype)

    times, main, eval_ms = {}, None, {}

    def timed(key, m, k, n, sr, eval_m=None):
        """Holds K6 at [m, k] x [k, n] (bf16; nearest with a bias, or
        stochastic without) and times it in turns beside the yardsticks;
        with eval_m also held and timed on the first eval_m rows. Returns
        (the least ms of each, the bound and what bounds it)."""
        nonlocal worst_abs
        x = fenced(torch, torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16))
        w = torch.randn(n, k, generator=gen, device=dev) * 0.05
        wq, ws = TQ.quantize_cols(w.t())
        wb = w.to(torch.bfloat16)
        bias = None if sr else torch.randn(n, generator=gen, device=dev) * 0.1
        bias_b = None if bias is None else bias.to(torch.bfloat16)
        tag = f"{key} M={m} K={k} N={n}"
        worst_abs = max(worst_abs, held(tag, x, wq, ws, bias, sr, torch.bfloat16))
        if eval_m is not None:  # evaluate() gives K6 the same layer at its batch
            x_eval = fenced(torch, x[:eval_m])
            worst_abs = max(worst_abs, held(f"{key} M={eval_m} K={k} N={n}", x_eval, wq, ws,
                                            bias, False, torch.bfloat16))
            eval_ms[key] = cuda_ms(
                lambda: TQ.qmm(x_eval, wq, ws, bias, seed, False, torch.bfloat16), 5)
            del x_eval
        xq = TQ.quantize_rows(x, seed, sr)[0]
        fns = {"plain": lambda: TQ.qmm_plain(x, wq, ws, bias, seed, sr, torch.bfloat16),
               "kernel": lambda: TQ.qmm(x, wq, ws, bias, seed, sr, torch.bfloat16),
               "bf16 F.linear": lambda: torch.nn.functional.linear(x, wb, bias_b),
               "library": lambda: int_mm_library(x, wq.t(), ws, bias),
               "torch._int_mm alone": lambda: torch._int_mm(xq, wq)}
        best, runs = in_turns(fns, 5)
        split = kernel_split(torch, fns["kernel"])
        bound_ms, bound_by = bound(nbytes(x, wq, ws, bias) + m * n * 2, 2.0 * m * k * n, "int8")
        print(f"  K6 {tag} bf16, ms per call: {runs}; K6's two kernels apart: "
              f"{json.dumps(split)}; bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        times[key] = {**{name: best[name] for name in fns}, "bound": bound_ms, "kernels": split}
        return best, bound_ms, bound_by

    for layer, (k_in, n_out) in TRUNK_B.items():
        for what, (k, n), sr in (("forward", (k_in, n_out), False), ("dgrad", (n_out, k_in), True)):
            best, bound_ms, bound_by = timed(f"{layer} {what}", M_TRAIN, k, n, sr,
                                             M_EVAL if what == "forward" else None)
            if (layer, what) == ("qkv", "forward"):
                main = {"ms": best["kernel"], "plain_ms": best["plain"],
                        "library_ms": best["library"], "bound_ms": bound_ms,
                        "bound_by": bound_by, "int_mm_ms": best["torch._int_mm alone"]}
    print(f"  K6 at evaluate()'s shapes (M={M_EVAL}, bf16, nearest, bias): {n_cases} cases so "
          f"far, {unequal} not equal to the bit; ms per call: "
          + ", ".join(f"{key} {t:.4f}" for key, t in eval_ms.items()), flush=True)
    times.update({f"{key} M={M_EVAL}": {"kernel": t} for key, t in eval_ms.items()})
    # ViT-H/16 224's trunk (width 1280, MLP 5120) at its train step's M =
    # 6,304, forward and dgrad, beside the same yardsticks
    for layer, (k_in, n_out) in TRUNK_H.items():
        for what, (k, n), sr in (("forward", (k_in, n_out), False), ("dgrad", (n_out, k_in), True)):
            timed(f"huge {layer} {what}", M_HUGE, k, n, sr)
    # the dgrad's stochastic rounding through seq shards' row windows: the
    # kernel against the plain version and the plain version against the
    # unsharded matrix's rows, both to the bit
    before = (n_cases, unequal)
    # ViT-B's qkv weight [2304, 768] in torch's layout: dgrad is g [*, 2304] · w
    w = torch.randn(2304, 768, generator=gen, device=dev) * 0.05
    wq, ws = TQ.quantize_cols(w)
    for (rows, start, n_tok), images in QUANT_WINDOWS:
        whole = torch.randn(images, n_tok, 2304, generator=gen, device=dev).to(torch.bfloat16)
        x = fenced(torch, whole[:, start:start + rows].reshape(-1, 2304))
        window = (rows, start, n_tok, 0)
        worst_abs = max(worst_abs, held(f"window {window} of {images} images", x, wq, ws, None,
                                        True, torch.bfloat16, window))
        rows_of = TQ.qmm_plain(whole.reshape(-1, 2304), wq, ws, None, seed, True, torch.bfloat16)
        rows_of = rows_of.reshape(images, n_tok, -1)[:, start:start + rows].reshape(x.shape[0], -1)
        check(torch.equal(TQ.qmm(x, wq, ws, None, seed, True, torch.bfloat16, window), rows_of),
              f"K6 through the window {window} is not the unsharded dgrad's rows")
        del whole, x, rows_of
    (rows, start, n_tok, _), images = TIMED_WINDOW
    x = torch.randn(images * rows, 2304, generator=gen, device=dev).to(torch.bfloat16)
    worst_abs = max(worst_abs, held(f"window {TIMED_WINDOW[0]} of {images} images", x, wq, ws,
                                    None, True, torch.bfloat16, TIMED_WINDOW[0]))
    best, runs = in_turns({
        "none": lambda: TQ.qmm(x, wq, ws, None, seed, True, torch.bfloat16),
        "window": lambda: TQ.qmm(x, wq, ws, None, seed, True, torch.bfloat16, TIMED_WINDOW[0])}, 5)
    print(f"  K6 through row windows (ViT-B/16 384's and ViT-L/16 512's shards, a 3-of-7 one): "
          f"{n_cases - before[0]} cases, {unequal - before[1]} not equal to the bit, each the "
          f"unsharded dgrad's rows to the bit; qkv's dgrad at M={x.shape[0]} (bf16, stochastic), "
          f"ms per call without / through the window {TIMED_WINDOW[0]}: {runs}", flush=True)
    times["window qkv dgrad"] = dict(best)
    del w, wq, x
    return {"max_abs_err": worst_abs, **main, "other_ms": times}


def phase11(torch, dev):
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    gen = torch.Generator(device=dev).manual_seed(11)
    seed = torch.tensor([0x0FEDCBA987654321], dtype=torch.int64, device=dev)
    n_cases = 0

    def held(tag, x, g):
        nonlocal n_cases
        sx, sg = TQ._col_scales(x), TQ._col_scales(g)
        inv_x, inv_g = sx.reciprocal(), sg.reciprocal()
        before = TQ.wgrad.launches
        acc = TQ.wgrad_acc(x, g, inv_x, inv_g, seed)
        check(TQ.wgrad.launches == before + 1, "wgrad_acc did not launch K7 once")
        ref = TQ.wgrad_acc_plain(x, g, inv_x, inv_g, seed)
        again = TQ.wgrad_acc(x, g, inv_x, inv_g, seed)
        dw, dw_ref = TQ.wgrad(x, g, seed), TQ.wgrad_plain(x, g, seed)
        torch.cuda.synchronize()
        check(acc.dtype == torch.int32 and acc.shape == ref.shape and acc.t().is_contiguous(),
              f"K7's sums are not an int32 [K, N] view of an [N, K] buffer ({tag})")
        diff = (acc.long() - ref.long()).abs().max().item()
        check(torch.equal(acc, ref), f"K7's int32 sums differ from the plain version's ({tag}: "
              f"by up to {diff})")
        check(torch.equal(acc, again), f"K7's sums differ between two runs ({tag})")
        check(torch.equal(dw, dw_ref), f"wgrad() differs from wgrad_plain() ({tag})")
        check(not torch.equal(dw, TQ.wgrad(x, g, seed + 1)), f"K7 ignores its seed ({tag})")
        n_cases += 1
        return (dw - dw_ref).abs().max().item()

    for dtype, (k, n) in itertools.product((torch.bfloat16, torch.float32), quant_shapes()):
        for m in (8, 197, 1000):
            x = fenced(torch, torch.randn(m, k, generator=gen, device=dev).to(dtype))
            g = fenced(torch, (torch.randn(m, n, generator=gen, device=dev) * 0.01).to(dtype))
            held(f"{str(dtype)[6:]} M={m} K={k} N={n}", x, g)
    print(f"  K7: {n_cases} cases (bf16/f32 x {len(quant_shapes())} shapes x M 8/197/1000, NaN "
          f"planted around x and g): int32 sums equal to the plain version's and bit-identical "
          f"between two runs", flush=True)
    try:
        TQ.wgrad(torch.zeros(4, 128, device=dev), torch.zeros(4, 128, device=dev), seed)
        check(False, "K7 took M=4")
    except ValueError:
        pass

    def int_mm_library(x, g):
        """The library yardstick: torch._int_mm between plain PyTorch passes
        that take the column scales, quantize both operands (to nearest),
        transpose both copies (the tokens contiguous in each, as the kernel's
        operands lie: int8 products take both operands with the contraction
        contiguous) and dequantize the result. Timed here and used nowhere
        in the port."""
        sx, sg = TQ._col_scales(x), TQ._col_scales(g)
        xq_t = torch.round(x.float() / sx).to(torch.int8).t().contiguous()
        gq = torch.round(g.float() / sg).to(torch.int8).t().contiguous().t()
        return torch._int_mm(xq_t, gq).float() * sx.reshape(-1, 1) * sg

    times, main, worst = {}, None, 0.0

    def timed(key, m, k, n):
        """Holds K7 at x [m, k], g [m, n] (bf16) and times it in turns beside
        the yardsticks. Returns (the least ms of each, the bound and what
        bounds it)."""
        nonlocal worst
        x = fenced(torch, torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16))
        g = fenced(torch, (torch.randn(m, n, generator=gen, device=dev) * 0.01)
                   .to(torch.bfloat16))
        tag = f"{key} M={m} K={k} N={n}"
        worst = max(worst, held(tag, x, g))
        sx, sg = TQ._col_scales(x), TQ._col_scales(g)
        inv_x, inv_g = sx.reciprocal(), sg.reciprocal()
        # both copies with the tokens contiguous, as K7's product reads them
        xq_t = torch.round(x.float() * inv_x).to(torch.int8).t().contiguous()
        gq = torch.round(g.float() * inv_g).to(torch.int8).t().contiguous().t()
        fns = {"plain": lambda: TQ.wgrad_plain(x, g, seed),
               "kernel": lambda: TQ.wgrad(x, g, seed),
               "launcher alone": lambda: TQ.wgrad_acc(x, g, inv_x, inv_g, seed),
               "bf16 x.T @ g": lambda: x.t() @ g,
               "library": lambda: int_mm_library(x, g),
               "torch._int_mm alone": lambda: torch._int_mm(xq_t, gq)}
        best, runs = in_turns(fns, 5)
        split = kernel_split(torch, fns["launcher alone"])
        bound_ms, bound_by = bound(nbytes(x, g, inv_x, inv_g) + k * n * 4, 2.0 * m * k * n,
                                   "int8")
        print(f"  K7 {tag} bf16, ms per call (\"kernel\" is wgrad() with its column-scale and "
              f"dequantizing passes, \"launcher alone\" K7's two kernels): {runs}; the "
              f"launcher's kernels apart: {json.dumps(split)}; bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
        times[key] = {**{name: best[name] for name in fns}, "bound": bound_ms, "kernels": split}
        return best, bound_ms, bound_by

    for layer, (k, n) in TRUNK_B.items():
        best, bound_ms, bound_by = timed(layer, M_TRAIN, k, n)
        if layer == "qkv":
            main = {"ms": best["kernel"], "plain_ms": best["plain"],
                    "library_ms": best["library"], "bound_ms": bound_ms, "bound_by": bound_by,
                    "int_mm_ms": best["torch._int_mm alone"]}
    # ViT-H/16 224's trunk at its train step's M = 6,304
    for layer, (k, n) in TRUNK_H.items():
        timed(f"huge {layer}", M_HUGE, k, n)
    # g's stochastic rounding through seq shards' row windows (ViT-B's qkv
    # shape): the kernel's int32 sums equal the plain version's, and the
    # shards' sums of one sequence (with the whole trunk's column scales)
    # add up to the unsharded call's exactly
    k, n = TRUNK_B["qkv"]
    wholes, sums, shards = {}, {}, {}
    for (rows, start, n_tok), images in QUANT_WINDOWS:
        if n_tok not in wholes:
            x = torch.randn(images, n_tok, k, generator=gen, device=dev).to(torch.bfloat16)
            g = (torch.randn(images, n_tok, n, generator=gen, device=dev) * 0.01).to(torch.bfloat16)
            inv = (TQ._col_scales(x.reshape(-1, k)).reciprocal(),
                   TQ._col_scales(g.reshape(-1, n)).reciprocal())
            wholes[n_tok] = (x, g, inv)
        x, g, (inv_x, inv_g) = wholes[n_tok]
        window = (rows, start, n_tok, 0)
        xl = fenced(torch, x[:, start:start + rows].reshape(-1, k))
        gl = fenced(torch, g[:, start:start + rows].reshape(-1, n))
        acc = TQ.wgrad_acc(xl, gl, inv_x, inv_g, seed, window)
        ref = TQ.wgrad_acc_plain(xl, gl, inv_x, inv_g, seed, window)
        check(torch.equal(acc, ref), f"K7's sums through the window {window} differ from the "
              "plain version's")
        sums[n_tok] = sums.get(n_tok, 0) + acc.long()
        shards[n_tok] = shards.get(n_tok, 0) + rows
        n_cases += 1
    for n_tok, (x, g, (inv_x, inv_g)) in wholes.items():
        whole = TQ.wgrad_acc(x.reshape(-1, k), g.reshape(-1, n), inv_x, inv_g, seed)
        if shards[n_tok] == n_tok:  # every rank's shard
            check(torch.equal(sums[n_tok], whole.long()),
                  f"two shards' int32 sums of N={n_tok} do not add up to the unsharded call's")
    (rows, start, n_tok, _), images = TIMED_WINDOW
    x = torch.randn(images * rows, k, generator=gen, device=dev).to(torch.bfloat16)
    g = (torch.randn(images * rows, n, generator=gen, device=dev) * 0.01).to(torch.bfloat16)
    inv_x, inv_g = TQ._col_scales(x).reciprocal(), TQ._col_scales(g).reciprocal()
    check(torch.equal(TQ.wgrad_acc(x, g, inv_x, inv_g, seed, TIMED_WINDOW[0]),
                      TQ.wgrad_acc_plain(x, g, inv_x, inv_g, seed, TIMED_WINDOW[0])),
          f"K7's sums through the window {TIMED_WINDOW[0]} differ from the plain version's")
    best, runs = in_turns({
        "none": lambda: TQ.wgrad_acc(x, g, inv_x, inv_g, seed),
        "window": lambda: TQ.wgrad_acc(x, g, inv_x, inv_g, seed, TIMED_WINDOW[0])}, 5)
    print(f"  K7 through row windows: {len(QUANT_WINDOWS) + 1} cases equal to the plain version's "
          f"int32 sums, the two shards of N = 577 and of N = 1025 adding up to the unsharded "
          f"call's; qkv at M={x.shape[0]}, K7's two kernels, ms per call without / through the "
          f"window {TIMED_WINDOW[0]}: {runs}", flush=True)
    times["window qkv"] = dict(best)
    del wholes, x, g
    return {"max_abs_err": worst, **main, "other_ms": times}


@contextlib.contextmanager
def quant_on_plain(TQ):
    """Inside, ``qmm`` and ``wgrad`` compute with their plain versions on the
    card too (same seeds and so the same rounding bits) and launch neither K6
    nor K7: the reference that the int8 model on the kernels is held against.
    Only this script does so; the package never takes a plain version for a
    CUDA tensor."""
    qmm, wgrad = TQ.qmm, TQ.wgrad
    TQ.qmm, TQ.wgrad = TQ.qmm_plain, TQ.wgrad_plain
    try:
        yield
    finally:
        TQ.qmm, TQ.wgrad = qmm, wgrad


def phase12(torch, FA, dev, k6_ms, k7_ms):
    """k6_ms, k7_ms: phase 10's and phase 11's times per layer at the train
    step's shapes, for the account of where the int8 step's time goes."""
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )
    from uncertainty_vit_tpu_torch.train.engine_finetune import (
        FinetuneHParams, init_finetune_state, make_finetune_train_step,
    )
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import cosine_schedule

    FA.BOUNDED_SCORES = True  # as phases 2 and 4
    cfg = get_preset("beit_base_patch16_224", use_shared_rel_pos_bias=True, init_values=0.1,
                     quant="int8")
    gen = torch.Generator(device=dev).manual_seed(12)

    qmm, wgrad = TQ.qmm, TQ.wgrad  # the counting wrappers, also inside quant_on_plain()

    def counts():
        return {**attention_counts(FA), "K6": qmm.launches, "K7": wgrad.launches}

    def reset():
        reset_attention_counts(FA)
        qmm.launches = wgrad.launches = 0

    # --- evaluate(): phase 2's model and batches with the int8 trunk
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    # a wider head than the init's 0.02, so that the logits stand clear of
    # the int8 noise floor they are compared at
    trunc_normal(0.1, 2.0)(model.head.weight, gen)
    bf16_model = VisionTransformer(cfg.replace(quant="none"), dtype=torch.bfloat16, device=dev,
                                   generator=gen)
    bf16_model.load_state_dict(model.state_dict())
    bs, nb = 128, 4
    images = [torch.randint(0, 256, (bs, 224, 224, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]

    def batches():
        for u8, lbl in zip(images, labels):
            yield normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD), lbl

    launches = {}
    torch.cuda.reset_peak_memory_stats()
    reset()
    metrics = evaluate(model, batches())  # no generator: evaluation draws nothing
    torch.cuda.synchronize()
    launches["int8_evaluate"] = counts()
    peak_eval = torch.cuda.max_memory_allocated() / 2**30
    print(f"  evaluate(): launches {launches['int8_evaluate']}; {json.dumps(metrics)}",
          flush=True)
    check(launches["int8_evaluate"] == {"K1": cfg.depth * nb, "K2": 0, "K3": 0, "K4": 0,
                                        "K6": 4 * cfg.depth * nb, "K7": 0},
          f"evaluate() launched {launches['int8_evaluate']}, expected K6 {4 * cfg.depth} and K1 "
          f"{cfg.depth} per forward")
    check(all(math.isfinite(v) for v in metrics.values()), "non-finite metric")
    fwd, bf16_fwd = make_eval_forward(model), make_eval_forward(bf16_model)
    x0 = next(batches())[0]
    logits = fwd(x0)
    check(tuple(logits.shape) == (bs, cfg.num_classes) and logits.dtype == torch.float32
          and torch.isfinite(logits).all().item(), "int8 logits are not finite f32 [128, 1000]")
    with quant_on_plain(TQ):
        before = counts()
        ref = fwd(x0)
        check(counts()["K6"] == before["K6"], "the plain reference forward launched K6")
    diff = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    exact = bf16_fwd(x0)
    print(f"  logits K6 vs its plain version: max|diff|={diff:.3e}, max|logit|={scale:.3e}, "
          f"ratio {diff / scale:.3e} (bound {LOGIT_REL_BOUND}); int8 vs bf16 trunk on the same "
          f"weights: ratio {(logits - exact).abs().max().item() / exact.abs().max().item():.3e}",
          flush=True)
    check(diff <= LOGIT_REL_BOUND * scale, "int8 logits disagree with the plain versions'")
    best, runs = in_turns({"bf16": lambda: bf16_fwd(x0), "int8": lambda: fwd(x0)}, 5)
    eval_rates = {name: [bs * 1000.0 / ms for ms in v] for name, v in runs.items()}
    print(f"  eval forward img/s at batch {bs} (information only): int8 {eval_rates['int8']}, "
          f"bf16 trunk {eval_rates['bf16']}; peak memory of evaluate() {peak_eval:.2f} GiB",
          flush=True)
    del model, bf16_model, images, logits, ref, exact

    # --- the finetune train step: phase 4's step with the int8 trunk
    tcfg = cfg.replace(drop_path_rate=0.1)
    bs = 160
    x = torch.randn(bs, 224, 224, 3, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
    hp = FinetuneHParams(num_classes=cfg.num_classes)
    lr = cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=500)

    def build(state_dict=None, **overrides):
        m = VisionTransformer(tcfg.replace(**overrides), dtype=torch.bfloat16, device=dev,
                              generator=gen)
        if state_dict is None:
            trunc_normal(0.2, 2.0)(m.rel_pos_bias.relative_position_bias_table, gen)
        else:
            m.load_state_dict(state_dict)
        opt = make_optimizer(m, weight_decay=0.05, layer_decay=0.65, depth=tcfg.depth)
        state = init_finetune_state(m, opt)
        state.step = 1  # the warm-up's learning rate is 0 at update 0
        return m, state, make_finetune_train_step(m, opt, hp, lr)

    def gens(seed):
        return (torch.Generator(device=dev).manual_seed(seed), torch.Generator().manual_seed(seed))

    tmodel, state, step = build()
    init = {k: v.detach().clone() for k, v in tmodel.state_dict().items()}
    n_steps = 3
    torch.cuda.reset_peak_memory_stats()
    reset()
    ms = [step(state, x, y, *gens(11 + i)) for i in range(n_steps)]
    torch.cuda.synchronize()
    launches["int8_train_step"] = counts()
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {n_steps} steps at batch {bs}: launches {launches['int8_train_step']}; " + "; ".join(
        f"loss {float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f}" for m in ms),
        flush=True)
    d = cfg.depth * n_steps
    check(launches["int8_train_step"] == {"K1": d, "K2": d, "K3": 0, "K4": 0, "K6": 8 * d,
                                          "K7": 4 * d},
          f"{n_steps} int8 train steps launched {launches['int8_train_step']}, expected per "
          f"step K6 {8 * cfg.depth}, K7 {4 * cfg.depth}, K1 and K2 {cfg.depth}")
    check(all(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
              for m in ms), "non-finite loss or grad norm")
    moved = 0
    for k, v in tmodel.state_dict().items():
        check(torch.isfinite(v).all().item(), f"non-finite parameter {k}")
        moved += int(not torch.equal(v, init[k]))
    check(moved == len(init), f"only {moved} of {len(init)} parameter tensors changed")

    # one step from the same weights and seeds: kernels, their plain versions
    # (the same rounding bits), and the bf16 trunk on the same batch
    _, st_k, step_k = build(init)
    m_k = step_k(st_k, x, y, *gens(30))
    del st_k, step_k
    _, st_p, step_p = build(init)
    before = counts()
    with quant_on_plain(TQ):
        m_p = step_p(st_p, x, y, *gens(30))
    torch.cuda.synchronize()
    check(counts()["K6"] == before["K6"] and counts()["K7"] == before["K7"],
          "the plain reference step launched K6 or K7")
    del st_p, step_p
    _, st_b, step_b = build(init, quant="none")
    m_b = step_b(st_b, x, y, *gens(30))
    loss_k, loss_p, loss_b = (float(m["loss"]) for m in (m_k, m_p, m_b))
    gn_k, gn_p, gn_b = (float(m["grad_norm"]) for m in (m_k, m_p, m_b))
    print(f"  one step, K6/K7 vs their plain versions vs the bf16 trunk: loss {loss_k:.6f} / "
          f"{loss_p:.6f} / {loss_b:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f} / {gn_b:.6f}",
          flush=True)
    check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
          "the int8 step's loss disagrees with the plain versions'")
    check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
          "the int8 step's grad norm disagrees with the plain versions'")

    rates = {"int8": [], "bf16": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        st, fn = (state, step) if name == "int8" else (st_b, step_b)
        g = gens(20)
        rates[name].append(bs * 1000.0 / cuda_ms(lambda: fn(st, x, y, *g), 5))
    print(f"  train step img/s at batch {bs} (information only): int8 {rates['int8']}, bf16 "
          f"trunk {rates['bf16']}; peak memory of the {n_steps} int8 steps {peak_train:.2f} GiB",
          flush=True)

    # where the int8 step's time goes: this run's kernel times at the step's
    # shapes times their launches per step, and the weight passes timed here
    # (per layer: the forward's quantize_cols, the dgrad's and its transposed
    # int8 copy, the layer-scale fold left out)
    def weight_passes(w):
        TQ.quantize_cols(w.t())
        TQ.quantize_cols(w)[0].t().contiguous()

    w_ms = sum(cuda_ms(lambda w=torch.randn(n, k, generator=gen, device=dev): weight_passes(w),
                       10) for k, n in TRUNK_B.values())
    step_ms = bs * 1000.0 / max(rates["int8"])
    parts = {
        "K6 forward": sum(k6_ms[f"{layer} forward"]["kernel"] for layer in TRUNK_B),
        "K6 dgrad": sum(k6_ms[f"{layer} dgrad"]["kernel"] for layer in TRUNK_B),
        "K7's two kernels": sum(k7_ms[layer]["launcher alone"] for layer in TRUNK_B),
        "wgrad()'s column-scale and dequantizing passes": sum(
            k7_ms[layer]["kernel"] - k7_ms[layer]["launcher alone"] for layer in TRUNK_B),
        "weight passes": w_ms,
    }
    parts = {name: cfg.depth * ms for name, ms in parts.items()}
    parts["the rest (attention, LayerNorm, GELU, casts, optimizer, host)"] = \
        step_ms - sum(parts.values())
    bf16_gemms = 3 * cfg.depth * sum(k6_ms[f"{layer} forward"]["bf16 F.linear"]
                                     for layer in TRUNK_B)
    print(f"  the int8 step's {step_ms:.1f} ms by this run's kernel times x launches per step: "
          + "; ".join(f"{name} {ms:.1f}" for name, ms in parts.items())
          + f"; the bf16 matmuls they replace ~{bf16_gemms:.1f} (3 x 12 x F.linear at the "
          f"forward shapes)", flush=True)
    return launches


def phase13(torch, FA, dev, step_rates):
    """The ViT-H slice (head width 80): (a) K1-K5 at D = 80 through phases 1,
    3, 7, 8 and 14 (their cases, tolerances and checks, H = 16), K1 timed at
    B=128 and K2 at the train step's B=32; (b) the full-depth model's
    evaluate() and train steps; (c) the finetune driver. Returns (each
    kernel's D = 80 entry, the launches of each path)."""
    d80 = {}
    for key, title, fn, kw in (
            ("K1", "phase 1's cases; B=128 and the train step's B=32", phase1,
             dict(h=16, train_b=32)),
            ("K2", "phase 3's cases; the train step's B=32", phase3, dict(h=16, train_b=32)),
            ("K3", "phase 7's cases; ViT-L/16 512's shapes", phase7, {}),
            ("K4", "phase 8's cases; ViT-L/16 512's train shape", phase8, {}),
            ("K5", "phase 14's cases and shards; one shard at B=8, N=1025", phase14, {})):
        print(f"  (a) {key} at head width 80: {title}", flush=True)
        d80[key] = fn(torch, FA, dev, d=80, **kw)
    paths = phase13_model(torch, FA, dev, step_rates)
    paths.update(phase13_driver(torch, FA, dev))
    return d80, paths


def phase13_model(torch, FA, dev, step_rates):
    """(b) A full-width, full-depth beit_huge_patch16_224 (width 1280, depth
    32, 16 heads of 80, N = 197; shared rel-pos bias, layer scale 0.1, seeded
    weights, bf16 on f32 parameters): evaluate() over 2 batches of 64 (K1 32
    a forward and nothing else; logits against the plain attention's, the
    metrics against a CPU recomputation from the same logits), 3 finetune
    steps at batch 32 (K1 and K2 32 a step), one step against the plain
    attention and one with attention dropout 0.05 against the plain versions
    on the same masks (phase 4's bounds). Returns the launches of each path."""
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )

    FA.BOUNDED_SCORES = True  # as cli/finetune.py trains and evaluates
    preset = "beit_huge_patch16_224"
    cfg = get_preset(preset, use_shared_rel_pos_bias=True, init_values=0.1)
    check((cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.head_dim) == (1280, 32, 16, 80),
          f"{preset} is not ViT-H/16: {cfg}")
    gen = torch.Generator(device=dev).manual_seed(13)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    # the rel-pos table at std 0.2 (the bias is not all zeros) and the head at
    # 0.5 (the logits stand apart, so the metrics' ranks are stable)
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    trunc_normal(0.5, 2.0)(model.head.weight, gen)
    check(all(blk.attn.use_kernel for blk in model.blocks),
          "a ViT-H block does not take the attention kernels")
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  (b) ViT-H/16 224: {n_params} params, depth {cfg.depth}, width {cfg.embed_dim}, "
          f"{cfg.num_heads} heads of {cfg.head_dim}, N={cfg.num_patches + 1}", flush=True)

    def counts():
        return kernel_counts(FA, TQ, DO)

    none = {k: 0 for k in counts()}

    # --- evaluate(): 2 batches of 64 uint8 images
    bs, nb = 64, 2
    images = [torch.randint(0, 256, (bs, 224, 224, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]

    def batches():
        for u8, lbl in zip(images, labels):
            yield normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD), lbl

    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(FA, TQ, DO)
    metrics = evaluate(model, batches())
    torch.cuda.synchronize()
    launches = {"huge_evaluate": counts()}
    peak_eval = torch.cuda.max_memory_allocated() / 2**30
    print(f"  evaluate(): launches {launches['huge_evaluate']}; {json.dumps(metrics)}", flush=True)
    check(launches["huge_evaluate"] == dict(none, K1=cfg.depth * nb),
          f"evaluate() launched {launches['huge_evaluate']}, expected K1 {cfg.depth * nb} only")
    fwd = make_eval_forward(model)
    logits = torch.cat([fwd(x) for x, _ in batches()])
    lab = torch.cat(labels)
    check(tuple(logits.shape) == (bs * nb, cfg.num_classes) and logits.dtype == torch.float32
          and torch.isfinite(logits).all().item(), "ViT-H logits are not finite f32 [128, 1000]")
    on_cpu = {k: float(v) for k, v in M.classification_metrics(logits.cpu(), lab.cpu()).items()}
    on_cpu["loss"] = on_cpu["nll"]
    check(sorted(metrics) == sorted(on_cpu), f"evaluate()'s metric keys {sorted(metrics)}")
    for k, v in on_cpu.items():
        check(abs(metrics[k] - v) <= METRIC_ATOL + METRIC_RTOL * abs(v),
              f"evaluate()'s {k} {metrics[k]} against the CPU's {v} from the same logits")
    x0 = next(batches())[0]
    with attention_on_plain(torch, FA):
        ref = fwd(x0)
    diff, scale = (logits[:bs] - ref).abs().max().item(), ref.abs().max().item()
    print(f"  logits K1 vs plain attention: max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio "
          f"{diff / scale:.3e} (bound {LOGIT_REL_BOUND}); evaluate()'s metrics equal the CPU's "
          f"from the same logits", flush=True)
    check(diff <= LOGIT_REL_BOUND * scale, "ViT-H logits disagree with the plain attention")
    def plain_fwd():
        with attention_on_plain(torch, FA):
            return fwd(x0)

    _, runs = in_turns({"plain": plain_fwd, "kernel": lambda: fwd(x0)}, 3)
    eval_rates = {k: [bs * 1000 / ms for ms in v] for k, v in runs.items()}
    print(f"  eval forward img/s at batch {bs} (information only): kernel {eval_rates['kernel']}, "
          f"plain attention {eval_rates['plain']}; peak memory of evaluate() {peak_eval:.2f} GiB",
          flush=True)
    del logits, ref, images, model

    # --- the finetune train step at batch 32
    def build(**overrides):
        return large_512_model(torch, dev, init, train=True, preset=preset, **overrides)

    def gens(seed):
        return large_512_gens(torch, dev, seed)

    def step_counts(depth_steps):
        return dict(none, K1=depth_steps, K2=depth_steps)

    bs_t, n_steps = 32, 3
    x = torch.randn(bs_t, 224, 224, 3, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (bs_t,), generator=gen, device=dev)
    tmodel, state, step = build()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(FA, TQ, DO)
    ms = [step(state, x, y, *gens(11 + i)) for i in range(n_steps)]
    torch.cuda.synchronize()
    launches["huge_train_step"] = counts()
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {n_steps} steps at batch {bs_t}: launches {launches['huge_train_step']}; " + "; ".join(
        f"loss {float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f}" for m in ms),
        flush=True)
    check(launches["huge_train_step"] == step_counts(cfg.depth * n_steps),
          f"{n_steps} train steps launched {launches['huge_train_step']}")
    check(all(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
              for m in ms), "non-finite loss or grad norm")
    moved = 0
    for k, v in tmodel.state_dict().items():
        check(torch.isfinite(v).all().item(), f"non-finite parameter {k}")
        moved += int(not torch.equal(v, init[k]))
    check(moved == len(init), f"only {moved} of {len(init)} parameter tensors changed")
    g = gens(20)
    train_ms = [cuda_ms(lambda: step(state, x, y, *g), 3) for _ in range(2)]
    print(f"  train step at batch {bs_t} (information only): "
          f"{[bs_t * 1000 / ms for ms in train_ms]} img/s ({train_ms} ms); peak memory of the "
          f"{n_steps} steps {peak_train:.2f} GiB; all {moved} parameter tensors changed; ViT-B/16 "
          f"224's step in this call (phase 4, batch 160): {step_rates['kernel']} img/s", flush=True)
    del tmodel, state, step

    # one step from the same weights and seeds on the kernels and on the plain
    # attention, and one with attention dropout 0.05 (the same masks)
    for what, overrides, seed in (("", {}, 30), (" with attn_drop_rate=0.05",
                                                 {"attn_drop_rate": 0.05}, 31)):
        _, st_k, step_k = build(**overrides)
        reset_kernel_counts(FA, TQ, DO)
        m_k = step_k(st_k, x, y, *gens(seed))
        torch.cuda.synchronize()
        key = "huge_train_step_attn_drop" if overrides else "huge_train_step_held"
        launches[key] = counts()
        check(launches[key] == step_counts(cfg.depth), f"the step{what} launched {launches[key]}")
        del st_k, step_k
        _, st_p, step_p = build(**overrides)
        with attention_on_plain(torch, FA):
            m_p = step_p(st_p, x, y, *gens(seed))
        torch.cuda.synchronize()
        check(counts() == launches[key], "the plain-attention reference step launched a kernel")
        del st_p, step_p
        loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
        gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
        print(f"  one step at batch {bs_t}{what}, K1/K2 vs their plain versions: loss "
              f"{loss_k:.6f} / {loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
        check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
              f"the ViT-H step's loss{what} disagrees with the plain versions'")
        check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
              f"the ViT-H step's grad norm{what} disagrees with the plain versions'")
    return launches


def phase13_driver(torch, FA, dev):
    """(c) cli.finetune.main with --model beit_huge_patch16_224 on seeded
    32x32 CIFAR-100 pickles and a seeded ViT-H .pth (100 classes): --eval
    over 256 images at batch 64 (K1 32 a forward and nothing else; logits
    against the plain attention's, the printed metrics against a CPU
    recomputation), one train epoch of 2 steps at batch 32 and its
    evaluation of 64 images (K1 and K2 32 a step), step 0 against the same
    run's step 0 on the plain attention (phase 4's bounds). Returns the
    launches of each run."""
    import tempfile

    import numpy as np

    from uncertainty_vit_tpu_torch.cli import builders as B
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
    from uncertainty_vit_tpu_torch.evals.collect import collect_logits
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    preset, depth = "beit_huge_patch16_224", 32
    n_test, n_train, bs_e, bs_t, spe, n_test_train = 256, 64, 64, 32, 2, 64
    rs = np.random.RandomState(13)
    test_images = rs.randint(0, 256, (n_test, 32, 32, 3), dtype=np.uint8)
    train_images = rs.randint(0, 256, (n_train, 32, 32, 3), dtype=np.uint8)
    cfg = get_preset(preset, num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)

    def counts():
        return kernel_counts(FA, TQ, DO)

    bounded = FA.BOUNDED_SCORES
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ev, tr = os.path.join(tmp, "eval"), os.path.join(tmp, "train")
            write_cifar100(ev, test_images, np.arange(n_test) % 100)
            write_cifar100(tr, train_images, np.arange(n_train) % 100, "train")
            write_cifar100(tr, test_images[:n_test_train], np.arange(n_test_train) % 100)
            pth = os.path.join(tmp, "vith.pth")
            t0 = time.perf_counter()
            write_vitb_pth(torch, dev, cfg, pth, 130)
            pth_s = time.perf_counter() - t0

            def args_of(root, bs, *extra):
                return FT.get_args_parser().parse_args([
                    "--model", preset, "--input_size", "224", "--data_set", "CIFAR100",
                    "--data_path", root, "--batch_size", str(bs), "--num_workers", "8",
                    "--finetune", pth, "--output_dir", os.path.join(tmp, "out"), *extra])

            # --- --eval over 256 images at batch 64
            args = args_of(ev, bs_e, "--eval")
            reset_kernel_counts(FA, TQ, DO)
            with watched_driver(torch, FT, counts) as rec:
                t0 = time.perf_counter()
                res = FT.main(args)["eval"]
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t0
            paths = {"cli14_huge_eval": counts()}
            none = {k: 0 for k in paths["cli14_huge_eval"]}
            n_fwd = n_test // bs_e
            eval_ms = rec["evals"][0]["ms"]
            print(f"  (c) --eval ({n_test} images at batch {bs_e}): launches "
                  f"{paths['cli14_huge_eval']}; {json.dumps(res)}; the evaluation {eval_ms:.2f} ms "
                  f"({n_test * 1000 / eval_ms:.1f} img/s from images, information only; the first "
                  f"batch's warm-up included), main() {eval_s:.2f} s with the model build and the "
                  f".pth import (the .pth written in {pth_s:.2f} s)", flush=True)
            check(paths["cli14_huge_eval"] == dict(none, K1=depth * n_fwd),
                  f"--eval launched {paths['cli14_huge_eval']}, expected K1 {depth * n_fwd} only")
            # the same model and batches through the driver's own pieces
            model, _ = FT.build_model(args, 100, dev)
            FT.load_variables(args, model)
            loader, _ = B.build_loaders(args, is_train=False)
            fwd = make_eval_forward(model)
            logits, lab = collect_logits(fwd, FT._eval_batches(loader, args, dev))
            with attention_on_plain(torch, FA):
                ref, _ = collect_logits(fwd, FT._eval_batches(loader, args, dev))
            del model
            check(logits.shape == (n_test, 100) and np.isfinite(logits).all(),
                  f"--eval logits {logits.shape}")
            diff, scale = float(np.abs(logits - ref).max()), float(np.abs(ref).max())
            print(f"  --eval logits vs the plain attention's on the same transformed images: "
                  f"max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio {diff / scale:.3e} "
                  f"(bound {LOGIT_REL_BOUND})", flush=True)
            check(diff <= LOGIT_REL_BOUND * scale,
                  "the driver's ViT-H logits disagree with the plain attention's")
            on_cpu = {k: float(v) for k, v in M.classification_metrics(
                torch.from_numpy(logits), torch.from_numpy(lab)).items()}
            on_cpu["loss"] = on_cpu["nll"]
            check(sorted(res) == sorted(on_cpu), f"--eval metric keys {sorted(res)}")
            for k, v in on_cpu.items():
                check(abs(res[k] - v) <= METRIC_ATOL + METRIC_RTOL * abs(v),
                      f"--eval printed {k} {res[k]}, recomputed on the CPU {v}")

            # --- one train epoch of 2 steps at batch 32 and its evaluation
            train_args = ["--epochs", "1", "--steps_per_epoch", str(spe), "--no_save_ckpt",
                          "--no_auto_resume", "--layer_decay", "0.75", "--drop_path", "0.1"]
            reset_kernel_counts(FA, TQ, DO)
            with watched_driver(torch, FT, counts) as rec:
                t0 = time.perf_counter()
                FT.main(args_of(tr, bs_t, *train_args))
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
            paths["cli14_huge_train"] = counts()
            n_eval = -(-n_test_train // bs_t)
            print(f"  train epoch of {spe} steps at batch {bs_t} and its evaluation of "
                  f"{n_test_train} images: launches {paths['cli14_huge_train']}; losses "
                  + ", ".join(f"{float(r['metrics']['loss']):.5f}" for r in rec["steps"])
                  + f"; main() {train_s:.2f} s", flush=True)
            expect = dict(none, K1=depth * (spe + n_eval), K2=depth * spe)
            check(paths["cli14_huge_train"] == expect,
                  f"the train epoch launched {paths['cli14_huge_train']}, expected {expect}")
            check(len(rec["steps"]) == spe and all(
                r["launches"] == dict(none, K1=depth, K2=depth) for r in rec["steps"]),
                  f"the driver's steps launched {[r['launches'] for r in rec['steps']]}")
            # step 0 runs at the warm-up's lr 0 (--warmup_lr), step 1 above it
            check(rec["steps"][1]["moved"], "the driver's step 1 left the parameters")
            for r in rec["steps"]:
                for k in ("loss", "grad_norm"):
                    check(math.isfinite(float(r["metrics"][k])), f"step {r['step']} {k}")
            m_k = rec["steps"][0]["metrics"]
            # step 0 on the plain attention: the same flags, so the same
            # state, first batch and per-step generators
            del rec["model"]
            gc.collect()  # the held optimizer sits in reference cycles
            # (inside attention_on_plain the attention wrappers count nothing)
            with watched_driver(torch, FT, dict) as rec_p:
                with attention_on_plain(torch, FA):
                    FT.main(args_of(tr, bs_t, *train_args[:2], "--steps_per_epoch", "1",
                                    *train_args[4:], "--disable_eval_during_finetuning"))
            torch.cuda.synchronize()
            m_p = rec_p["steps"][0]["metrics"]
            del rec_p
            gc.collect()
            loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
            gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
            print(f"  the driver's step 0, kernels vs plain attention: loss {loss_k:.6f} / "
                  f"{loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
            check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
                  "the driver's ViT-H loss disagrees with the plain attention's")
            check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
                  "the driver's ViT-H grad norm disagrees with the plain attention's")
    finally:
        FA.BOUNDED_SCORES = bounded
    return paths


# K5's query and key counts on the card: one query row, a tile-ragged 63, and
# the shards of N = 1025 at S = 4 (257) and S = 2 (513); 65, 577 and 1025 keys
# (1 mod 64: one valid key in the last k/v tile).
CROSS_NQ = (1, 63, 257, 513)
CROSS_NK = (65, 577, 1025)


def cross_parts(got):
    """(dq, dk, dv, dbias, dqvb) of K5's backward (dq, dkv, dbias, dqvb)."""
    dq, dkv, dbias, dqvb = got
    return (dq, *dkv.chunk(2, dim=-1), dbias, dqvb)


def cross_plain_bwd(torch, FA, q, kv, bias, qvb, lse, out, g, scale, h, step=2):
    """K5's two plain versions `step` images at a time, the row sums formed
    from the forward's output `out`, or with `out` None recomputed as
    rowsum(t) over the keys: (dq, dk, dv, dbias, dqvb)."""
    c = q.shape[-1]
    dq, dkv, dbias = [], [], None
    for i in range(0, q.shape[0], step):
        sl = slice(i, i + step)
        dq_i, db_i, c_i = FA.cross_bwd_dq_plain(q[sl], kv[sl], bias, qvb, lse[sl], g[sl], scale, h,
                                                out=None if out is None else out[sl])
        dkv.append(FA.cross_bwd_dkv_plain(q[sl], kv[sl], bias, qvb, lse[sl], c_i, g[sl], scale, h))
        dq.append(dq_i)
        if db_i is not None:
            dbias = db_i if dbias is None else dbias + db_i
    dq, dkv = torch.cat(dq), torch.cat(dkv)
    dqvb = FA.cross_qv_bias_grad(dq, dkv) if qvb is not None else None
    return dq, dkv[..., :c], dkv[..., c:], dbias, dqvb


def cross_plain_bwd_both(torch, FA, q, kv, bias, qvb, lse, out, g, scale, h):
    """``cross_plain_bwd`` with the row sums recomputed, then formed from
    ``out``: the two references of ``held_bwd_both``."""
    return [cross_plain_bwd(torch, FA, q, kv, bias, qvb, lse, o, g, scale, h) for o in (None, out)]


def cross_counts(FA) -> dict:
    return {"K5": FA.cross_qkv_attention.launches, "K5_bwd": FA.cross_qkv_attention_bwd.launches}


def reset_cross_counts(FA) -> None:
    FA.cross_qkv_attention.launches = FA.cross_qkv_attention_bwd.launches = 0


def phase14(torch, FA, dev, d=64, h=16):
    """K5 at head width d with h heads (ViT-L's 16 x 64 unless given): the
    case grid, its checks and the shards against K3/K4; at d = 64 the shapes
    phase 15 gives K5; then one shard of ViT-L/16 512's train shape."""
    gen = torch.Generator(device=dev).manual_seed(14)
    c, scale = h * d, d**-0.5
    worst, n_cases = 0.0, 0
    for dtype, nq, nk in itertools.product((torch.bfloat16, torch.float32), CROSS_NQ, CROSS_NK):
        name = str(dtype)[6:]
        q = torch.randn(2, nq, c, generator=gen, device=dev).to(dtype)
        kv = torch.randn(2, nk, 2 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, nq, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, nq, nk, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        for has_bias, has_qvb, bounded in itertools.product((True, False), repeat=3):
            b_ = bias if has_bias else None
            q_ = qvb if has_qvb else None
            tag = (f"{name} Nq={nq} Nk={nk} bias={has_bias:d} qv_bias={has_qvb:d} "
                   f"bounded={bounded:d}")
            before, before_s = cross_counts(FA), attention_counts(FA)
            out, lse = FA.cross_qkv_attention(q, kv, b_, q_, scale, h, bounded_scores=bounded,
                                              want_lse=True)
            out_only = FA.cross_qkv_attention(q, kv, b_, q_, scale, h, bounded_scores=bounded)
            got = FA.cross_qkv_attention_bwd(q, kv, b_, q_, lse, g, scale, h, out=out)
            again = FA.cross_qkv_attention_bwd(q, kv, b_, q_, lse, g, scale, h, out=out)
            after = cross_counts(FA)
            check(after["K5"] == before["K5"] + 2 and after["K5_bwd"] == before["K5_bwd"] + 2
                  and attention_counts(FA) == before_s,
                  f"K5 was not launched twice each way, or K1-K4 were ({tag})")
            ref, ref_lse = FA.cross_fwd_plain(q, kv, b_, q_, scale, h, bounded_scores=bounded)
            ref_bwd = cross_plain_bwd_both(torch, FA, q, kv, b_, q_, lse, out, g, scale, h)
            torch.cuda.synchronize()
            tol = OUT_TOL[name]
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            check(torch.isfinite(out.float()).all().item() and out.shape == q.shape
                  and out.dtype == dtype, f"K5 output is not finite [2, Nq, C] ({tag})")
            check(torch.allclose(out.float(), ref.float(), atol=tol, rtol=tol),
                  f"K5 output disagrees with the plain version ({tag}: {err:.3e})")
            check(lse_err <= LSE_ATOL, f"K5 lse disagrees with the plain version ({tag})")
            check(torch.equal(out, out_only), f"K5 output depends on want_lse ({tag})")
            check(got[0].dtype == dtype and got[0].shape == q.shape and got[1].shape == kv.shape,
                  f"K5 dq / dkv dtype or shape ({tag})")
            check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                  f"K5's dq or dkv differs between two runs ({tag})")
            abs_err, msg = held_bwd_both(torch, "K5", tag, cross_parts(got), ref_bwd,
                                         BWD_TOL[name])
            worst, n_cases = max(worst, err, abs_err), n_cases + 1
            if has_bias and has_qvb and not bounded:
                print(f"  K5 {tag}: max|out-plain|={err:.3e} max|lse-plain|={lse_err:.3e}; "
                      f"{msg}", flush=True)
        del q, kv, g, bias, out, lse, got, again, ref, ref_bwd
    print(f"  K5: {n_cases} cases within K1's and K2's bounds (the backward of both plain "
          f"versions: the row sums recomputed, and formed from the output), dq and dkv "
          f"bit-identical between two runs, worst max|plain diff| {worst:.3e}", flush=True)
    check(FA.cross_qkv_attention(torch.randn(1, 1, c, device=dev), torch.randn(1, 1, 2 * c,
                                 device=dev), None, None, scale, h).shape == (1, 1, c),
          "K5 at one query row and one key")

    # NaN planted right before and right behind q, kv, g, the output and the
    # lse changes no bit of out, lse, dq or dkv
    for dtype, (nq, nk) in itertools.product((torch.bfloat16, torch.float32),
                                             ((63, 577), (513, 1025))):
        q = torch.randn(2, nq, c, generator=gen, device=dev).to(dtype)
        kv = torch.randn(2, nk, 2 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, nq, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, nq, nk, generator=gen, device=dev) * 0.5
        out, lse = FA.cross_qkv_attention(q, kv, bias, None, scale, h, bounded_scores=False,
                                          want_lse=True)
        got = FA.cross_qkv_attention_bwd(q, kv, bias, None, lse, g, scale, h, out=out)
        f_q, f_kv, f_g, f_lse = (fenced(torch, t) for t in (q, kv, g, lse))
        f_out, f_lse_out = FA.cross_qkv_attention(f_q, f_kv, bias, None, scale, h,
                                                  bounded_scores=False, want_lse=True)
        f_got = FA.cross_qkv_attention_bwd(f_q, f_kv, bias, None, f_lse, f_g, scale, h,
                                           out=fenced(torch, out))
        torch.cuda.synchronize()
        tag = f"{str(dtype)[6:]} Nq={nq} Nk={nk}"
        check(torch.equal(out, f_out) and torch.equal(lse, f_lse_out),
              f"K5 reads behind the end of q or kv ({tag})")
        check(torch.equal(got[0], f_got[0]) and torch.equal(got[1], f_got[1])
              and torch.isfinite(f_got[2]).all().item(),
              f"K5's backward reads behind the end of q, kv, g, out or lse ({tag})")
        print(f"  K5 {tag}: NaN planted around q, kv, g, out and lse changes no bit of out, lse, "
              f"dq and dkv", flush=True)
        del q, kv, g, bias, got, f_got, f_q, f_kv, f_g

    # the S shards of K5 together against K3 and K4 of the whole sequence
    for dtype, n, s in itertools.product((torch.bfloat16, torch.float32), (577, 1025), (2, 4)):
        name = str(dtype)[6:]
        qkv = torch.randn(2, n, 3 * c, generator=gen, device=dev).to(dtype)
        g = torch.randn(2, n, c, generator=gen, device=dev).to(dtype)
        bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        out, lse = FA.fused_qkv_attention(qkv, bias, qvb, None, scale, h, bounded_scores=True,
                                          want_lse=True)
        dqkv, dbias, dqvb = FA.fused_qkv_attention_bwd(qkv, bias, qvb, lse, g, scale, h, out=out)
        kv = qkv[..., c:].contiguous()
        outs, dqs, dkv, dbias_rows, dqvb_sum = [], [], 0.0, [], 0.0
        m = -(-n // s)
        for r in range(s):
            rows = slice(r * m, min((r + 1) * m, n))
            q_r, b_r = qkv[:, rows, :c].contiguous(), bias[:, rows].contiguous()
            o_r, l_r = FA.cross_qkv_attention(q_r, kv, b_r, qvb, scale, h, bounded_scores=True,
                                              want_lse=True)
            dq_r, dkv_r, db_r, dqvb_r = FA.cross_qkv_attention_bwd(
                q_r, kv, b_r, qvb, l_r, g[:, rows].contiguous(), scale, h, out=o_r)
            outs.append(o_r), dqs.append(dq_r), dbias_rows.append(db_r)
            dkv, dqvb_sum = dkv + dkv_r.float(), dqvb_sum + dqvb_r
        torch.cuda.synchronize()
        tag = f"{name} N={n} S={s}"
        o = torch.cat(outs, dim=1)
        err = (o.float() - out.float()).abs().max().item()
        check(torch.allclose(o.float(), out.float(), atol=OUT_TOL[name], rtol=OUT_TOL[name]),
              f"K5's shards disagree with K3's output ({tag}: {err:.3e})")
        tol = BWD_TOL[name]
        parts = {"dq": (torch.cat(dqs, dim=1), dqkv[..., :c], tol["dqkv"]),
                 "dkv": (dkv, dqkv[..., c:], tol["dqkv"]),
                 "dbias": (torch.cat(dbias_rows, dim=1), dbias, tol["dbias"]),
                 "dqvb": (dqvb_sum, dqvb, tol["dqvb"])}
        msg = []
        for part, (a, ref, bound_) in parts.items():
            rel = _rel_err(a, ref)
            msg.append(f"{part} rel={rel:.3e}")
            check(rel <= bound_, f"K5's shards disagree with K4's {part} ({tag}: {rel:.3e})")
        worst = max(worst, err)
        print(f"  K5's {s} shards vs K3/K4 of the whole sequence, {tag}: max|out-K3|={err:.3e}; "
              + ", ".join(msg), flush=True)
        del qkv, g, bias, out, lse, dqkv, dbias, kv, outs, dqs, dkv, dbias_rows

    # at every shape phase 15's path gives K5 (bf16, a bias, the q/v bias,
    # bounded; Nk = 1025): evaluate() at B=16 (no lse) and the train step at
    # B=8 (the lse and the backward), on rank 0's 513 query rows and rank 1's
    # 512 (whole 64-row tiles, no query tail); the plain versions 4 images
    # (forward) and 2 images (backward) at a time
    n = 1025
    for bsz, nq, train in ((16, 513, False), (16, 512, False), (8, 513, True),
                           (8, 512, True)) if d == 64 else ():
        q = torch.randn(bsz, nq, c, generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn(bsz, n, 2 * c, generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn(h, nq, n, generator=gen, device=dev) * 0.5
        qvb = torch.randn(3, c, generator=gen, device=dev) * 0.3
        qvb[1] = 0.0
        before = cross_counts(FA)
        if train:
            g = torch.randn(bsz, nq, c, generator=gen, device=dev).to(torch.bfloat16)
            out, lse = FA.cross_qkv_attention(q, kv, bias, qvb, scale, h, bounded_scores=True,
                                              want_lse=True)
            got = FA.cross_qkv_attention_bwd(q, kv, bias, qvb, lse, g, scale, h, out=out)
        else:
            out = FA.cross_qkv_attention(q, kv, bias, qvb, scale, h, bounded_scores=True)
        after = cross_counts(FA)
        check(after["K5"] == before["K5"] + 1
              and after["K5_bwd"] == before["K5_bwd"] + int(train), "K5 was not launched")
        refs = [FA.cross_fwd_plain(q[i:i + 4], kv[i:i + 4], bias, qvb, scale, h,
                                   bounded_scores=True) for i in range(0, bsz, 4)]
        ref = torch.cat([r[0] for r in refs])
        torch.cuda.synchronize()
        tag = f"phase 15's {'train step' if train else 'evaluate()'} B={bsz} Nq={nq} Nk={n}"
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.isfinite(out.float()).all().item() and out.shape == q.shape,
              f"K5 output is not finite [B, Nq, C] ({tag})")
        check(torch.allclose(out.float(), ref.float(), atol=OUT_TOL["bfloat16"],
                             rtol=OUT_TOL["bfloat16"]),
              f"K5 output disagrees with the plain version ({tag}: {err:.3e})")
        msg = ""
        if train:
            lse_err = (lse - torch.cat([r[1] for r in refs])).abs().max().item()
            check(lse_err <= LSE_ATOL, f"K5 lse disagrees with the plain version ({tag})")
            abs_err, msg = held_bwd_both(torch, "K5", tag, cross_parts(got), cross_plain_bwd_both(
                torch, FA, q, kv, bias, qvb, lse, out, g, scale, h), BWD_TOL["bfloat16"])
            worst = max(worst, abs_err)
            msg = f" max|lse-plain|={lse_err:.3e}; {msg}"
        worst = max(worst, err)
        print(f"  K5 at {tag}: max|out-plain|={err:.3e}{msg}", flush=True)
        del q, kv, bias, out, refs, ref
        if train:
            del lse, got, g

    # one shard at the ViT-L/16 512 train shape (B=8, N=1025, H=16, bf16, bias,
    # bounded, the lse kept) for S = 2 (Nq = 513) and S = 4 (Nq = 257), beside
    # K3 (with the lse) and K4 of the whole sequence, the plain versions and
    # one library call (scaled_dot_product_attention with the bias as a float
    # mask, forward, and autograd's backward of it)
    bsz, n = 8, 1025
    qkv = torch.randn(bsz, n, 3 * c, generator=gen, device=dev).to(torch.bfloat16)
    g_full = torch.randn(bsz, n, c, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, n, n, generator=gen, device=dev) * 0.5
    kv = qkv[..., c:].contiguous()
    out_full, lse_full = FA.fused_qkv_attention(qkv, bias, None, None, scale, h,
                                                bounded_scores=True, want_lse=True)
    fns, shards = {}, {}
    for s in (2, 4):
        nq = -(-n // s)
        q = qkv[:, :nq, :c].contiguous()
        b_r = bias[:, :nq].contiguous()
        g = g_full[:, :nq].contiguous()
        out, lse = FA.cross_qkv_attention(q, kv, b_r, None, scale, h, bounded_scores=True,
                                          want_lse=True)
        k_h = kv[..., :c].view(bsz, n, h, d).transpose(1, 2)
        v_h = kv[..., c:].view(bsz, n, h, d).transpose(1, 2)
        q_leaf = q.view(bsz, nq, h, d).transpose(1, 2).detach().requires_grad_()
        kv_leaves = (k_h.detach().requires_grad_(), v_h.detach().requires_grad_())
        mask_leaf = b_r.to(torch.bfloat16).requires_grad_()
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            q_leaf, *kv_leaves, attn_mask=mask_leaf, scale=scale)
        g_h = g.view(bsz, nq, h, d).transpose(1, 2)
        shards[s] = (q, b_r, g, lse, out, lib_out)
        fns[f"S={s} forward"] = (lambda q=q, b_r=b_r: FA.cross_qkv_attention(
            q, kv, b_r, None, scale, h, bounded_scores=True, want_lse=True))
        fns[f"S={s} backward"] = (lambda q=q, b_r=b_r, g=g, lse=lse, out=out:
                                  FA.cross_qkv_attention_bwd(q, kv, b_r, None, lse, g, scale, h,
                                                             out=out))
        fns[f"S={s} plain forward"] = (lambda q=q, b_r=b_r: torch.cat([FA.cross_fwd_plain(
            q[i:i + 4], kv[i:i + 4], b_r, None, scale, h, bounded_scores=True)[0]
            for i in range(0, bsz, 4)]))
        fns[f"S={s} plain backward"] = (lambda q=q, b_r=b_r, g=g, lse=lse, out=out: cross_plain_bwd(
            torch, FA, q, kv, b_r, None, lse, out, g, scale, h))
        fns[f"S={s} library forward"] = (
            lambda q=q, mask=mask_leaf.detach(): torch.nn.functional.scaled_dot_product_attention(
                q.view(bsz, -1, h, d).transpose(1, 2), k_h, v_h, attn_mask=mask, scale=scale))
        fns[f"S={s} library backward"] = (
            lambda lib_out=lib_out, q_leaf=q_leaf, kv_leaves=kv_leaves, mask_leaf=mask_leaf,
            g_h=g_h: torch.autograd.grad(lib_out, (q_leaf, *kv_leaves, mask_leaf), g_h,
                                         retain_graph=True))
        got = fns[f"S={s} forward"]()[0].float()
        ref = fns[f"S={s} plain forward"]().float()
        err = (got - ref).abs().max().item()
        check(torch.allclose(got, ref, atol=OUT_TOL["bfloat16"], rtol=OUT_TOL["bfloat16"]),
              f"K5 disagrees with the plain version at the timed S={s} shard ({err:.3e})")
        abs_err, msg = held_bwd_both(
            torch, "K5", f"timed S={s}", cross_parts(fns[f"S={s} backward"]()),
            cross_plain_bwd_both(torch, FA, q, kv, b_r, None, lse, out, g, scale, h),
            BWD_TOL["bfloat16"])
        worst = max(worst, err, abs_err)
        print(f"  K5 at the S={s} shard B={bsz} Nq={nq} Nk={n}: max|out-plain|={err:.3e}; {msg}",
              flush=True)
    fns["K3 whole, with lse"] = lambda: FA.fused_qkv_attention(
        qkv, bias, None, None, scale, h, bounded_scores=True, want_lse=True)
    fns["K4 whole"] = lambda: FA.fused_qkv_attention_bwd(qkv, bias, None, lse_full, g_full, scale,
                                                         h, out=out_full)
    best, runs = in_turns(fns, 5)
    print(f"  K5 one shard at B={bsz} N={n} H={h} D={d} bf16 (bias, bounded), ms per call: {runs}",
          flush=True)
    q, b_r, g, lse, out, _ = shards[2]
    nq = q.shape[1]
    # the function's own traffic: the backward's read of the output (for the
    # row sums) is this design's, not the function's
    bound_ms, bound_by = bound(nbytes(q, kv, b_r) + nbytes(q, lse)  # forward: out, lse
                               + nbytes(q, kv, g, lse, b_r) + nbytes(q, kv, b_r),  # backward
                               14.0 * bsz * h * nq * n * d, "bfloat16")
    # "ms" and the others are forward + backward of the S = 2 shard
    return {"max_abs_err": worst, "ms": best["S=2 forward"] + best["S=2 backward"],
            "plain_ms": best["S=2 plain forward"] + best["S=2 plain backward"],
            "library_ms": best["S=2 library forward"] + best["S=2 library backward"],
            "bound_ms": bound_ms, "bound_by": bound_by, "other_ms": dict(best)}


def leaf_grad_norms(torch, model) -> dict:
    """Each parameter's gradient norm (f32), by name."""
    names, grads = zip(*((k, p.grad) for k, p in model.named_parameters()))
    return dict(zip(names, torch.stack([g.float().norm() for g in grads]).cpu().tolist()))


def seq2_rank(group, path):
    """One rank of phase 15: ViT-L/16 512 with its tokens split over the
    group, on the one card. Returns what the parent holds and prints."""
    import torch

    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )
    from uncertainty_vit_tpu_torch.parallel import seq

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    FA.BOUNDED_SCORES = True
    saved = torch.load(path, map_location=dev)
    u8, labels = saved["eval_images"], saved["eval_labels"]
    x = normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD)
    model, _, _ = large_512_model(torch, dev, saved["init"], group)
    out = {"rows": group.rows(model.cfg.num_patches + 1)}

    def counts():
        return {**attention_counts(FA), **cross_counts(FA)}

    def reset():
        reset_attention_counts(FA)
        reset_cross_counts(FA)

    torch.cuda.reset_peak_memory_stats()
    reset()
    out["metrics"] = evaluate(model, iter([(x, labels)]))
    torch.cuda.synchronize()
    out["evaluate"] = counts()
    out["peak_eval_gib"] = torch.cuda.max_memory_allocated() / 2**30
    fwd = make_eval_forward(model)
    out["logits"] = fwd(x).cpu()
    out["eval_ms"] = [host_ms(torch, lambda: fwd(x)) for _ in range(2)]
    del model, fwd

    tmodel, state, step = large_512_model(torch, dev, saved["init"], group, train=True)
    xt, yt = saved["train_x"], saved["train_y"]
    torch.cuda.reset_peak_memory_stats()
    reset()
    ms = []
    for i in range(2):
        ms.append(step(state, xt, yt, *large_512_gens(torch, dev, 11 + i)))
        if i == 0:  # the gradients after the group's sum, before step 2
            out["grad_norms"] = leaf_grad_norms(torch, tmodel)
    torch.cuda.synchronize()
    out["train_step"] = counts()
    out["peak_train_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["steps"] = [(float(m["loss"]), float(m["grad_norm"])) for m in ms]
    out["finite"] = all(torch.isfinite(v).all().item() for v in tmodel.state_dict().values())
    out["step_ms"] = [host_ms(torch, lambda: step(state, xt, yt, *large_512_gens(torch, dev, 20)))
                      for _ in range(2)]

    # the path's collectives, the least ms of 3 calls after one: a layer's k/v
    # gather in evaluate() at batch 16, its backward (an all-reduce of the
    # cotangent and a slice) at the train step's batch 8, and one 256 MB
    # bucket of the gradient sum
    n, c = tmodel.cfg.num_patches + 1, tmodel.cfg.embed_dim
    del tmodel, state, step
    rows, bs_eval = out["rows"][1] - out["rows"][0], x.shape[0]
    kv_eval = torch.randn(bs_eval, rows, 2 * c, device=dev).to(torch.bfloat16)
    kv_train = torch.randn(xt.shape[0], rows, 2 * c, device=dev).to(torch.bfloat16)
    kv_train.requires_grad_()
    gathered = seq.gather_tokens(kv_train, group, n)
    cot = torch.randn_like(gathered)
    bucket = torch.ones(1 << 26, device=dev)

    def least_ms(fn):
        return min([host_ms(torch, fn) for _ in range(4)][1:])

    out["collective_ms"] = {
        f"k/v gather [{bs_eval}, {rows}, {2 * c}] bf16": least_ms(
            lambda: seq.gather_tokens(kv_eval, group, n)),
        f"its backward [{xt.shape[0]}, {n}, {2 * c}] bf16": least_ms(
            lambda: torch.autograd.grad(gathered, kv_train, cot, retain_graph=True)),
        "gradient sum, one bucket of 2^26 f32": least_ms(
            lambda: seq.sum_in_place([bucket], group)),
    }
    return out


def phase15(torch, FA, dev, init):
    """ViT-L/16 512 token-sharded over two gloo ranks that share the card,
    against the same model unsharded in this process."""
    import tempfile

    from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )
    from uncertainty_vit_tpu_torch.parallel import seq

    FA.BOUNDED_SCORES = True
    gen = torch.Generator(device=dev).manual_seed(15)
    bs, bs_t = 16, 8
    saved = {
        "init": init,
        "eval_images": torch.randint(0, 256, (bs, 512, 512, 3), generator=gen, device=dev,
                                     dtype=torch.uint8),
        "eval_labels": torch.randint(0, 1000, (bs,), generator=gen, device=dev),
        "train_x": torch.randn(bs_t, 512, 512, 3, generator=gen, device=dev),
        "train_y": torch.randint(0, 1000, (bs_t,), generator=gen, device=dev),
    }
    # the unsharded model on the same batch, weights and generator seeds
    model, _, _ = large_512_model(torch, dev, init)
    x = normalize(to_float(saved["eval_images"]), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD)
    ref_logits = make_eval_forward(model)(x)
    del model
    tmodel, state, step = large_512_model(torch, dev, init, train=True)
    m = step(state, saved["train_x"], saved["train_y"], *large_512_gens(torch, dev, 11))
    ref_loss, ref_gn = float(m["loss"]), float(m["grad_norm"])
    ref_norms = leaf_grad_norms(torch, tmodel)
    del tmodel, state, step, m
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "phase15.pt")
        torch.save(saved, path)
        del saved
        t0 = time.perf_counter()
        ranks = seq.run_ranks(seq2_rank, 2, path, timeout=900.0)
        secs = time.perf_counter() - t0
    depth = 24
    for r, res in enumerate(ranks):
        print(f"  rank {r}: token rows {res['rows']}; evaluate() launches {res['evaluate']}, "
              f"{json.dumps(res['metrics'])}; 2 train steps launches {res['train_step']}; "
              + "; ".join(f"loss {l:.6f} grad_norm {gn:.6f}" for l, gn in res["steps"]),
              flush=True)
        check(res["evaluate"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": depth, "K5_bwd": 0},
              f"rank {r}'s evaluate() launched {res['evaluate']}, expected K5 {depth} only")
        check(res["train_step"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 2 * depth,
                                    "K5_bwd": 2 * depth},
              f"rank {r}'s 2 train steps launched {res['train_step']}, expected K5 {depth} "
              f"each way per step only")
        check(all(math.isfinite(v) for v in res["metrics"].values()), "non-finite metric")
        check(res["finite"] and all(math.isfinite(l) and math.isfinite(gn)
                                    for l, gn in res["steps"]),
              f"rank {r}'s train steps left a non-finite loss, grad norm or parameter")
    a, b = ranks[0], ranks[1]
    check(torch.equal(a["logits"], b["logits"]), "the two ranks' logits differ")
    check(a["steps"] == b["steps"], "the two ranks' losses or grad norms differ")
    ref = ref_logits.cpu()
    diff, scale = (a["logits"] - ref).abs().max().item(), ref.abs().max().item()
    loss, gn = a["steps"][0]
    print(f"  sharded vs unsharded: logits max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio "
          f"{diff / scale:.3e} (bound {LOGIT_REL_BOUND}); step 1 loss {loss:.6f} / {ref_loss:.6f}, "
          f"grad norm {gn:.6f} / {ref_gn:.6f}", flush=True)
    check(a["logits"].shape == (bs, 1000) and diff <= LOGIT_REL_BOUND * scale,
          "the sharded L/512 logits disagree with the unsharded model's")
    check(abs(loss - ref_loss) <= LOSS_REL_BOUND * abs(ref_loss),
          "the sharded L/512 step's loss disagrees with the unsharded step's")
    check(abs(gn - ref_gn) <= GRAD_NORM_REL_BOUND * abs(ref_gn),
          "the sharded L/512 step's grad norm disagrees with the unsharded step's")
    # every leaf's gradient: equal on the two ranks after the group's sum (a
    # leaf left unsummed keeps each rank's own share), and its norm against the
    # unsharded step's (a leaf summed twice doubles)
    check(list(a["grad_norms"]) == list(ref_norms) and a["grad_norms"] == b["grad_norms"],
          "the two ranks' gradients differ after the group's sum")
    rel = {k: abs(a["grad_norms"][k] - v) / v if v > 0 else float(a["grad_norms"][k] != 0)
           for k, v in ref_norms.items()}
    worst_leaf = max(rel, key=rel.get)
    print(f"  step 1's gradients: equal on both ranks; worst leaf {worst_leaf}: norm "
          f"{a['grad_norms'][worst_leaf]:.6e} / {ref_norms[worst_leaf]:.6e} unsharded, relative "
          f"difference {rel[worst_leaf]:.3e} (bound {LEAF_GRAD_REL_BOUND}); the "
          f"{len(rel)} leaves' median {sorted(rel.values())[len(rel) // 2]:.3e}", flush=True)
    check(rel[worst_leaf] <= LEAF_GRAD_REL_BOUND,
          f"the sharded L/512 step's gradient of {worst_leaf} disagrees with the unsharded step's")
    for r, res in enumerate(ranks):
        print(f"  rank {r} (information only: two ranks share one card and gather through host "
              f"memory over gloo): eval forward at batch {bs} "
              f"{[bs * 1000 / ms for ms in res['eval_ms']]} img/s, train step at batch {bs_t} "
              f"{[bs_t * 1000 / ms for ms in res['step_ms']]} img/s; peak memory evaluate() "
              f"{res['peak_eval_gib']:.2f} GiB, train {res['peak_train_gib']:.2f} GiB; "
              f"collectives, ms each: {json.dumps(res['collective_ms'])}", flush=True)
    print(f"  the two ranks ran {secs:.1f} s from start to end", flush=True)
    return {path: {k: sum(r[path][k] for r in ranks) for k in ("K5", "K5_bwd")}
            for path in ("evaluate", "train_step")}


def kernel_counts(FA, TQ, DO) -> dict:
    """Every kernel's launches since the last reset_kernel_counts."""
    return {**attention_counts(FA), **cross_counts(FA), "K6": TQ.qmm.launches,
            "K7": TQ.wgrad.launches, "K8": DO.fused_dropout.launches}


def reset_kernel_counts(FA, TQ, DO) -> None:
    reset_attention_counts(FA)
    reset_cross_counts(FA)
    TQ.qmm.launches = TQ.wgrad.launches = DO.fused_dropout.launches = 0


def write_cifar100(root: str, images, labels, split: str = "test") -> None:
    """A cifar-100-python/{split} pickle of uint8 NHWC images (the (N, 3072)
    rows of the CIFAR layout)."""
    import pickle

    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, split), "wb") as f:
        pickle.dump({b"data": images.transpose(0, 3, 1, 2).reshape(len(images), -1),
                     b"fine_labels": [int(v) for v in labels]}, f)


def write_vitb_pth(torch, dev, cfg, path: str, seed: int) -> None:
    """A .pth ({"model": state_dict}) of a seeded model of config cfg (ViT-B/16
    224; ViT-H/16 224 in phase 13): the rel-pos table at std 0.2 and the head
    at 0.5, so that the bias is not zero and the logits stand apart."""
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer

    gen = torch.Generator(device=dev).manual_seed(seed)
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev, generator=gen)
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    trunc_normal(0.5, 2.0)(model.head.weight, gen)
    torch.save({"model": {k: v.cpu() for k, v in model.state_dict().items()}}, path)


def trace_summary(prof) -> tuple:
    """(kernel and copy ms, the card's idle ms before its first kernel,
    between kernels (the union of their intervals) and after its last,
    the top 8 kernels by ms) of a torch.profiler trace."""
    events = [e for e in prof.events() if e.device_type.name == "CUDA" and not e.is_user_annotation]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1000
    by_kernel = {}
    for e in events:
        name = re.sub(r"^void |\(anonymous namespace\)::", "", e.name).split("(")[0][:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    cpu = [e.time_range for e in prof.events() if e.device_type.name == "CPU"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    idle = {"before": 0.0, "between": 0.0, "after": 0.0}
    if spans and cpu:
        idle["before"] = (spans[0][0] - min(r.start for r in cpu)) / 1000
        idle["after"] = (max(r.end for r in cpu) - max(e for _, e in spans)) / 1000
        reach = spans[0][1]
        for start, end in spans[1:]:
            idle["between"] += max(start - reach, 0) / 1000
            reach = max(reach, end)
    return busy_ms, idle, {k: round(v / 1000, 3) for k, v in top}


def phase16(torch, FA, dev, det_ms_per_128):
    """The finetune driver's evaluation from images on the card:
    cli.finetune.main under --eval, --mc_dropout, --ensembles and
    --quant int8, from CIFAR-100 pickles and .pth files written here.
    det_ms_per_128: phase 2's forward at batch 128, for the rate beside.
    Returns the launches of each path, and the --eval run's metrics and
    logits (phase 27 holds a converted checkpoint to them)."""
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from uncertainty_vit_tpu_torch.cli import builders as B
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
    from uncertainty_vit_tpu_torch.evals.collect import collect_logits
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.ops.augment import eval_transform_batch
    from uncertainty_vit_tpu_torch.utils import native
    from uncertainty_vit_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                                          load_torch_state_dict)

    n_images, n_small, bs, depth = 1024, 256, 128, 12
    rs = np.random.RandomState(16)
    images = rs.randint(0, 256, (n_images, 32, 32, 3), dtype=np.uint8)
    labels = np.arange(n_images) % 100
    # the driver's model for these flags: phase 2's ViT-B/16 224 (shared
    # rel-pos table, layer scale 0.1, no absolute position embedding as the
    # flags default) with a 100-class head; the rel-pos table at std 0.2 and
    # the head at 0.5, so that the bias is not zero and the logits stand apart
    cfg = get_preset("beit_base_patch16_224", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)

    def held_metrics(got, logits, lab, what):
        """The driver's printed metrics against the same metrics of these
        logits on the CPU (evaluate() adds "loss", evaluate_ensemble() does
        not)."""
        on_cpu = {k: float(v) for k, v in M.classification_metrics(
            torch.from_numpy(logits), torch.from_numpy(lab)).items()}
        if "loss" in got:
            on_cpu["loss"] = on_cpu["nll"]
        check(sorted(got) == sorted(on_cpu), f"{what} metric keys {sorted(got)}")
        for k, v in on_cpu.items():
            check(abs(got[k] - v) <= METRIC_ATOL + METRIC_RTOL * abs(v),
                  f"{what} metric {k}: printed {got[k]}, recomputed on the CPU {v}")

    bounded = FA.BOUNDED_SCORES
    try:
        with tempfile.TemporaryDirectory() as tmp:
            full, small = os.path.join(tmp, "full"), os.path.join(tmp, "small")
            write_cifar100(full, images, labels)
            write_cifar100(small, images[:n_small], labels[:n_small])
            a, b = os.path.join(tmp, "a.pth"), os.path.join(tmp, "b.pth")
            write_vitb_pth(torch, dev, cfg, a, 160)
            write_vitb_pth(torch, dev, cfg, b, 161)

            def args_of(root, *extra):
                return FT.get_args_parser().parse_args([
                    "--model", "beit_base_patch16_224", "--input_size", "224",
                    "--data_set", "CIFAR100", "--data_path", root, "--batch_size", str(bs),
                    "--num_workers", "8", "--finetune", a, "--output_dir",
                    os.path.join(tmp, "out"), "--eval", *extra])

            # --- --eval over 1024 images: one warm-up run, then the counted run
            args = args_of(full)
            FT.main(args)
            reset_kernel_counts(FA, TQ, DO)
            t0 = time.perf_counter()
            res = FT.main(args)["eval"]
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            paths = {"cli_evaluate": kernel_counts(FA, TQ, DO)}
            print(f"  --eval ({n_images} images): launches {paths['cli_evaluate']}", flush=True)
            want = {k: 0 for k in paths["cli_evaluate"]}
            check(paths["cli_evaluate"] == dict(want, K1=depth * n_images // bs),
                  f"--eval launched {paths['cli_evaluate']}, expected K1 "
                  f"{depth * n_images // bs} only")

            # the same model and batches through the driver's own pieces: the
            # logits behind the printed metrics, and the plain attention's
            model, _ = FT.build_model(args, 100, dev)
            FT.load_variables(args, model)
            loader, _ = B.build_loaders(args, is_train=False)
            logits, lab = collect_logits(make_eval_forward(model),
                                         FT._eval_batches(loader, args, dev))
            plain = VisionTransformer(cfg.replace(use_flash_attention=False), dtype=torch.bfloat16,
                                      device=dev)
            plain.load_state_dict(model.state_dict())
            ref, _ = collect_logits(make_eval_forward(plain), FT._eval_batches(loader, args, dev))
            del plain
            check(logits.shape == (n_images, 100) and np.isfinite(logits).all(),
                  f"logits {logits.shape}, finite {np.isfinite(logits).all()}")
            check(np.array_equal(lab, labels), "the loader's labels are not the split's")
            diff, scale = float(np.abs(logits - ref).max()), float(np.abs(ref).max())
            print(f"  --eval logits vs the plain attention's on the same transformed images: "
                  f"max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio {diff / scale:.3e} "
                  f"(bound {LOGIT_REL_BOUND})", flush=True)
            check(diff <= LOGIT_REL_BOUND * scale,
                  "the driver's logits disagree with the plain-attention model's")
            held_metrics(res, logits, lab, "--eval")
            eval_ref = {"eval": dict(res), "logits": logits, "cpu": {
                k: float(v) for k, v in M.classification_metrics(
                    torch.from_numpy(logits), torch.from_numpy(lab)).items()}}
            first = torch.from_numpy(images[:bs])
            on_card = eval_transform_batch(first.to(dev), 224, 224 / 256).cpu()
            cpu = eval_transform_batch(first, 224, 224 / 256)
            tdiff = (on_card - cpu).abs().max().item()
            print(f"  eval transform 32 -> 224 on the card vs on the CPU: max|diff|={tdiff:.3e} "
                  f"(bound 1e-5)", flush=True)
            check(tuple(on_card.shape) == (bs, 224, 224, 3) and tdiff <= 1e-5,
                  "the eval transform on the card disagrees with the CPU's")

            # --- the rate from images (information only)
            host = []
            for _ in range(2):
                t0 = time.perf_counter()
                for _batch in loader:
                    pass
                host.append((time.perf_counter() - t0) * 1000)
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                FT.run_eval_dispatch(args, model, loader, 100)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            # its two parts: the logits (loader, copies, transform, forwards,
            # readback), then the metrics of all of them on the card
            t0 = time.perf_counter()
            collected = collect_logits(make_eval_forward(model),
                                       FT._eval_batches(loader, args, dev))
            collect_ms = (time.perf_counter() - t0) * 1000
            t0 = time.perf_counter()
            on_card = M.classification_metrics(*(torch.from_numpy(a).to(dev) for a in collected))
            check(all(math.isfinite(float(v)) for v in on_card.values()), "non-finite metric")
            metrics_ms = (time.perf_counter() - t0) * 1000
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                FT.run_eval_dispatch(args, model, loader, 100)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1000
            busy_ms, idle, top = trace_summary(prof)
            print(f"  native IO library available: {native.available()}"
                  + ("" if native.available() else f" ({native.BUILD_ERROR}); the loader "
                     "stacks with numpy"), flush=True)
            print(f"  --eval from images (information only): run_eval_dispatch over {n_images} "
                  f"images {[round(w * 1000, 2) for w in walls]} ms = "
                  f"{[n_images / w for w in walls]} img/s; of it the logits {collect_ms:.2f} ms "
                  f"and their metrics {metrics_ms:.2f} ms; main() incl. model build and .pth "
                  f"import {main_s * 1000:.1f} ms; the loader alone {host} ms; phase 2's "
                  f"forward at batch {bs}: {bs * 1000 / det_ms_per_128:.1f} img/s", flush=True)
            print(f"  profiled run_eval_dispatch: wall {wall_ms:.2f} ms, CUDA kernel and copy "
                  f"time {busy_ms:.2f} ms, busy share {busy_ms / wall_ms:.3f}; the card idle "
                  f"(ms) {json.dumps({k: round(v, 2) for k, v in idle.items()})} its first "
                  f"kernel, between, after its last; top kernels (ms): " + json.dumps(top),
                  flush=True)
            del model, loader

            # --- --mc_dropout over 256 images: split at block 9, dropout from 9
            split = 9
            reset_kernel_counts(FA, TQ, DO)
            res = FT.main(args_of(small, "--mc_dropout", "--mc_dropout_forwards", "8",
                                  "--mc_dropout_split_at", str(split), "--drop", "0.1",
                                  "--dropout_from_block", str(split)))["mc_dropout"]
            torch.cuda.synchronize()
            paths["cli_mc_dropout"] = kernel_counts(FA, TQ, DO)
            nb = n_small // bs
            expect = dict(want, K1=depth * nb, K8=2 * (depth - split) * nb)
            print(f"  --mc_dropout: launches {paths['cli_mc_dropout']}", flush=True)
            check(paths["cli_mc_dropout"] == expect,
                  f"--mc_dropout launched {paths['cli_mc_dropout']}, expected {expect}")
            check(all(math.isfinite(v) for v in res.values()), "non-finite MC metric")

            # --- --ensembles of a.pth and b.pth over 256 images
            reset_kernel_counts(FA, TQ, DO)
            res = FT.main(args_of(small, "--ensembles", "--ensemble_checkpoints", a, b))
            torch.cuda.synchronize()
            paths["cli_ensemble"] = kernel_counts(FA, TQ, DO)
            expect = dict(want, K1=2 * depth * nb)
            print(f"  --ensembles: launches {paths['cli_ensemble']}", flush=True)
            check(paths["cli_ensemble"] == expect,
                  f"--ensembles launched {paths['cli_ensemble']}, expected {expect}")
            members = res["ensembles"]["members"]
            check(len(members) == 2 and members[0] != members[1]
                  and all(math.isfinite(v) for m in members + [res["ensembles"]["ensemble"]]
                          for v in m.values()), "ensemble metrics")
            # each member on its own through the same batches: its logits'
            # metrics, and those of the mean logits, recomputed on the CPU
            sargs = args_of(small)
            model, _ = FT.build_model(sargs, 100, dev)
            loader, _ = B.build_loaders(sargs, is_train=False)
            member_logits = []
            for path in (a, b):
                state, _, _ = import_torch_state_dict(load_torch_state_dict(path),
                                                      model.state_dict())
                model.load_state_dict(state)
                lg, lab = collect_logits(make_eval_forward(model),
                                         FT._eval_batches(loader, sargs, dev))
                member_logits.append(lg)
            check(np.array_equal(lab, labels[:n_small]), "the loader's labels are not the split's")
            for got, lg in zip(members + [res["ensembles"]["ensemble"]],
                               member_logits + [np.mean(member_logits, axis=0)]):
                held_metrics(got, lg, lab, "--ensembles")
            print(f"  --ensembles metrics equal to the CPU's from each member's own logits and "
                  f"their mean (rtol {METRIC_RTOL}, atol {METRIC_ATOL})", flush=True)
            del model

            # --- --quant int8 over 256 images
            reset_kernel_counts(FA, TQ, DO)
            res = FT.main(args_of(small, "--quant", "int8"))["eval"]
            torch.cuda.synchronize()
            paths["cli_int8_evaluate"] = kernel_counts(FA, TQ, DO)
            expect = dict(want, K1=depth * nb, K6=4 * depth * nb)
            print(f"  --quant int8: launches {paths['cli_int8_evaluate']}", flush=True)
            check(paths["cli_int8_evaluate"] == expect,
                  f"--quant int8 launched {paths['cli_int8_evaluate']}, expected {expect}")
            check(all(math.isfinite(v) for v in res.values()), "non-finite int8 metric")
            # the same int8 model on the same batches: the logits behind the
            # printed metrics, and K6's against its plain version's (phase 12)
            qargs = args_of(small, "--quant", "int8")
            model, _ = FT.build_model(qargs, 100, dev)
            FT.load_variables(qargs, model)
            loader, _ = B.build_loaders(qargs, is_train=False)
            logits, lab = collect_logits(make_eval_forward(model),
                                         FT._eval_batches(loader, qargs, dev))
            held_metrics(res, logits, lab, "--quant int8")
            k6, before = TQ.qmm, TQ.qmm.launches
            with quant_on_plain(TQ):
                ref, _ = collect_logits(make_eval_forward(model),
                                        FT._eval_batches(loader, qargs, dev))
            check(k6.launches == before, "the plain reference forward launched K6")
            diff, scale = float(np.abs(logits - ref).max()), float(np.abs(ref).max())
            print(f"  --quant int8 logits vs the same model on qmm's plain version: "
                  f"max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio {diff / scale:.3e} "
                  f"(bound {LOGIT_REL_BOUND})", flush=True)
            check(diff <= LOGIT_REL_BOUND * scale,
                  "the driver's int8 logits disagree with qmm's plain version's")
            del model
    finally:
        FA.BOUNDED_SCORES = bounded
    return paths, eval_ref


def phase17(torch, FA, dev, step_rates):
    """The finetune driver's training from images on the card:
    cli.finetune.main without --eval from CIFAR-100 pickles and a ViT-B/16
    224 .pth written here (two epochs, a resumed third, a first step on the
    plain attention, an int8 epoch), and the train transform against the
    CPU's. step_rates: phase 4's step-only img/s, for the rate beside."""
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from uncertainty_vit_tpu_torch.cli import builders as B
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.ops import augment as A
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.ops import randaugment as RA
    from uncertainty_vit_tpu_torch.train.engine_finetune import step_generators

    n_train, n_test, bs, depth, spe = 1280, 256, 160, 12, 4
    eval_fwd = -(-n_test // bs)  # forwards per evaluation: 160 + 96
    rs = np.random.RandomState(17)
    train_images = rs.randint(0, 256, (n_train, 32, 32, 3), dtype=np.uint8)
    test_images = rs.randint(0, 256, (n_test, 32, 32, 3), dtype=np.uint8)
    cfg = get_preset("beit_base_patch16_224", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)

    # what the driver does, seen through its own entry points: each call of
    # its train step (metrics, host clock, launches), each evaluation (ms,
    # launches), the state auto_load restored; a profiler over chosen steps
    steps, evals, resumed, profiled = [], [], [], {}
    make_step, evaluate, auto_load = FT.make_finetune_train_step, FT.E.evaluate, FT.C.auto_load

    def recording_make_step(*a, **k):
        step = make_step(*a, **k)

        def recorded(state, *args):
            if profiled.get("start") == state.step:
                torch.cuda.synchronize()
                profiled["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                profiled["prof"].start()
                profiled["t"] = time.perf_counter()
            if profiled.get("stop") == state.step:
                torch.cuda.synchronize()
                profiled["wall_ms"] = (time.perf_counter() - profiled["t"]) * 1000
                profiled["prof"].stop()
            # inside attention_on_plain the attention wrappers are plain
            # functions, which count nothing
            counted = hasattr(FA.fused_qkv_attention_bwd, "launches")
            before = kernel_counts(FA, TQ, DO) if counted else None
            t = time.perf_counter()
            # one warm step (transform, mixup, forward, backward, AdamW)
            # with any host synchronization an error
            checked = profiled.get("sync_check") == state.step
            if checked:
                torch.cuda.set_sync_debug_mode("error")
            try:
                m = step(state, *args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            profiled["sync_checked"] = profiled.get("sync_checked", False) or checked
            after = kernel_counts(FA, TQ, DO) if counted else None
            steps.append({"step": state.step - 1, "t": t, "metrics": m,
                          "launches": counted and {k: after[k] - before[k] for k in after}})
            return m

        return recorded

    def timed_evaluate(*a, **k):
        torch.cuda.synchronize()
        before = kernel_counts(FA, TQ, DO)
        t = time.perf_counter()
        out = evaluate(*a, **k)
        torch.cuda.synchronize()
        after = kernel_counts(FA, TQ, DO)
        evals.append({"t": t, "ms": (time.perf_counter() - t) * 1000,
                      "launches": {k: after[k] - before[k] for k in after}})
        return out

    def recording_auto_load(output_dir, state):
        state, epoch = auto_load(output_dir, state)
        resumed.append({"epoch": epoch, "step": state.step,
                        "model": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
                        "optimizer": {i: {k: v.clone() for k, v in st.items()} for i, st in
                                      state.optimizer.state_dict()["state"].items()}})
        return state, epoch

    def finite_metrics(records, what):
        for r in records:
            for k in ("loss", "grad_norm"):
                check(math.isfinite(float(r["metrics"][k])),
                      f"{what}: step {r['step']} {k} {float(r['metrics'][k])}")

    bounded = FA.BOUNDED_SCORES
    FT.make_finetune_train_step, FT.E.evaluate, FT.C.auto_load = (
        recording_make_step, timed_evaluate, recording_auto_load)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_cifar100(tmp, train_images, np.arange(n_train) % 100, "train")
            write_cifar100(tmp, test_images, np.arange(n_test) % 100, "test")
            pth = os.path.join(tmp, "vitb.pth")
            write_vitb_pth(torch, dev, cfg, pth, 170)
            out = os.path.join(tmp, "out")

            def args_of(out_dir, *extra):
                return FT.get_args_parser().parse_args([
                    "--model", "beit_base_patch16_224", "--input_size", "224",
                    "--data_set", "CIFAR100", "--data_path", tmp, "--batch_size", str(bs),
                    "--num_workers", "8", "--finetune", pth, "--output_dir", out_dir,
                    "--steps_per_epoch", str(spe), "--save_ckpt_freq", "1",
                    "--layer_decay", "0.65", "--drop_path", "0.1", *extra])

            # --- the main path: two epochs of 4 steps, each with its evaluation
            args = args_of(out, "--epochs", "2")
            profiled["sync_check"] = spe + 2
            reset_kernel_counts(FA, TQ, DO)
            t0 = time.perf_counter()
            state = FT.main(args)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            paths = {"cli_train": kernel_counts(FA, TQ, DO)}
            want = {k: 0 for k in paths["cli_train"]}
            n_steps = 2 * spe
            print(f"  train 2 epochs x {spe} steps at batch {bs}: launches {paths['cli_train']}",
                  flush=True)
            expect = dict(want, K1=depth * (n_steps + 2 * eval_fwd), K2=depth * n_steps)
            check(paths["cli_train"] == expect,
                  f"the train run launched {paths['cli_train']}, expected {expect}")
            run1, eval1 = list(steps), list(evals)
            check(len(run1) == n_steps and state.step == n_steps,
                  f"{len(run1)} step calls, state step {state.step}")
            for r in run1:
                check(r["launches"] == dict(want, K1=depth, K2=depth),
                      f"step {r['step']} launched {r['launches']}")
            for e in eval1:
                check(e["launches"] == dict(want, K1=depth * eval_fwd),
                      f"an evaluation launched {e['launches']}")
            finite_metrics(run1, "train")
            check(profiled.pop("sync_checked", False), "the step under sync debug mode did not run")
            print(f"  step {profiled.pop('sync_check')} ran with torch.cuda.set_sync_debug_mode("
                  f"'error'): no host synchronization inside the driver's step", flush=True)
            with open(os.path.join(out, "log.txt")) as f:
                log = [json.loads(line) for line in f]
            check([r["epoch"] for r in log] == [0, 1]
                  and all("test_acc1" in r and "test_ece" in r and math.isfinite(r["train_loss"])
                          for r in log), f"log.txt: {log}")
            for name in ("checkpoint-0.pth", "checkpoint-1.pth", "checkpoint-best.pth"):
                check(os.path.isfile(os.path.join(out, name)), f"{name} was not written")
            print("  losses " + ", ".join(f"{float(r['metrics']['loss']):.4f}" for r in run1)
                  + "; lr " + ", ".join(f"{r['metrics']['lr']:.3e}" for r in run1)
                  + f"; log.txt test_acc1 {[r['test_acc1'] for r in log]}, test_ece "
                  f"{[round(r['test_ece'], 4) for r in log]}", flush=True)
            del state
            # the rate: the host clock from an epoch's first step call to the
            # end of its last step (the card synchronized before its evaluation)
            rates = [spe * bs / (eval1[e]["t"] - run1[e * spe]["t"]) for e in range(2)]
            print(f"  driver train rate from images (information only; host clock over an "
                  f"epoch's {spe} steps, evaluation apart): {rates} img/s (epoch 0 includes the "
                  f"first call's warm-up); phase 4's step-only rate in this call: "
                  f"kernel {step_rates['kernel']}, plain attention {step_rates['plain']} img/s; "
                  f"each epoch's evaluation of {n_test} images {[round(e['ms'], 2) for e in eval1]}"
                  f" ms; main() with model build, .pth import and checkpoints {main_s:.2f} s",
                  flush=True)

            # --- the first step on the plain attention: the same flags, so the
            # same state, first batch and per-step generators
            steps.clear()
            reset_kernel_counts(FA, TQ, DO)
            with attention_on_plain(torch, FA):
                FT.main(args_of(os.path.join(tmp, "plain"), "--epochs", "1", "--steps_per_epoch",
                                "1", "--disable_eval_during_finetuning", "--no_save_ckpt",
                                "--no_auto_resume"))
            torch.cuda.synchronize()
            check(kernel_counts(FA, TQ, DO) == want, "the plain-attention run launched a kernel")
            m_k, m_p = run1[0]["metrics"], steps[0]["metrics"]
            loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
            gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
            print(f"  driver's step 0, kernels vs plain attention: loss {loss_k:.6f} / "
                  f"{loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
            check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
                  "the driver's first loss disagrees with the plain attention's")
            check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
                  "the driver's first grad norm disagrees with the plain attention's")

            # --- the train transform on the card against the CPU's, on the
            # driver's first batch with the draws of its step 0
            loader, _ = B.build_loaders(args, is_train=True, letterbox_ok=True)
            loader.set_epoch(0)
            first = next(iter(loader))[0]
            aa = FT._aa_kwargs(args)
            flags = dict(color_jitter_strength=args.color_jitter, reprob=args.reprob,
                         imagenet_default_mean_and_std=args.imagenet_default_mean_and_std,
                         interpolation=B.interp_method(args.train_interpolation),
                         re_mode=args.remode, re_count=args.recount, **aa)
            draw_flags = {k: flags[k] for k in ("color_jitter_strength", "reprob",
                                                "auto_augment", "re_mode", "re_count")}
            draws = A.draw_finetune_train_augment(step_generators(args.seed, 0, dev).augment, bs,
                                                  224, **draw_flags)
            u8 = torch.from_numpy(first).to(dev)
            on_card = A.finetune_train_augment_batch(draws, u8, 224, **flags).cpu()
            cpu_draws = draws.to("cpu")
            on_cpu = A.finetune_train_augment_batch(cpu_draws, torch.from_numpy(first), 224, **flags)

            def crop(d, x):
                return A.random_hflip_batch(d.flip_u, A.random_resized_crop_batch(
                    d.rrc, A.to_planar(x), 224, method=flags["interpolation"]))

            planar = crop(draws, u8)
            crop_diff = (planar.cpu() - crop(cpu_draws, torch.from_numpy(first))).abs().max().item()
            diff = (on_card - on_cpu).abs()
            near = (diff > AUG_NEAR_ATOL).float().mean().item()
            flips = (diff > AUG_FLIP_ATOL).float().mean().item()
            print(f"  train transform {tuple(first.shape)} -> {tuple(on_card.shape)}, card vs CPU "
                  f"on the same draws: crop and flip max|diff| {crop_diff:.3e} (bound "
                  f"{AUG_CROP_ATOL}); whole transform max|diff| {diff.max().item():.3e}, share "
                  f"beyond {AUG_NEAR_ATOL} {near:.2e} (bound {AUG_NEAR_SHARE}), beyond two bf16 "
                  f"ulps {AUG_FLIP_ATOL:.4f} {flips:.2e} (bound {AUG_FLIP_SHARE})", flush=True)
            check(tuple(on_card.shape) == (bs, 224, 224, 3) and bool(torch.isfinite(on_card).all()),
                  "the train transform's output")
            check(crop_diff <= AUG_CROP_ATOL, "the crop on the card disagrees with the CPU's")
            check(near <= AUG_NEAR_SHARE and flips <= AUG_FLIP_SHARE,
                  "the train transform on the card disagrees with the CPU's")
            # its time at the driver's batch: draws and transform, and its parts
            aug_fn = A.make_finetune_train_augment(224, **flags)
            g = torch.Generator(device=dev).manual_seed(5)
            times = {
                "aug_fn": cuda_ms(lambda: aug_fn(g, u8), 10),
                "draws": cuda_ms(lambda: A.draw_finetune_train_augment(g, bs, 224, **draw_flags),
                                 10),
                "crop_flip": cuda_ms(lambda: crop(draws, u8), 10),
                "rand_augment": cuda_ms(lambda: RA.rand_augment_batch(
                    draws.rand_augment, planar, magnitude=aa["aa_magnitude"],
                    magnitude_std=aa["aa_magnitude_std"]), 10),
                "erasing": cuda_ms(lambda: A.random_erasing_batch(
                    draws.erasing, planar, prob=args.reprob, mode=args.remode,
                    count=args.recount), 10),
            }
            print(f"  train transform ms per batch of {bs} (CUDA events, information only): "
                  + json.dumps({k: round(v, 3) for k, v in times.items()}), flush=True)
            del planar, on_card, on_cpu, draws, cpu_draws

            # --- --epochs 3 on the same directory: auto-resumes at epoch 2 from
            # checkpoint-1.pth; steps 9 and 10 profiled
            steps.clear()
            evals.clear()
            resumed.clear()  # run 1's auto_load found nothing
            profiled.update(start=2 * spe + 1, stop=2 * spe + 3)
            args3 = args_of(out, "--epochs", "3")
            reset_kernel_counts(FA, TQ, DO)
            state = FT.main(args3)
            torch.cuda.synchronize()
            paths["cli_train_resume"] = kernel_counts(FA, TQ, DO)
            expect = dict(want, K1=depth * (spe + eval_fwd), K2=depth * spe)
            check(paths["cli_train_resume"] == expect,
                  f"the resumed run launched {paths['cli_train_resume']}, expected {expect}")
            check(len(resumed) == 1 and resumed[0]["epoch"] == 2 and resumed[0]["step"] == n_steps,
                  f"auto-resume: {[(r['epoch'], r['step']) for r in resumed]}")
            blob = torch.load(os.path.join(out, "checkpoint-1.pth"), map_location=dev,
                              weights_only=False)
            check(blob["step"] == n_steps and blob["epoch"] == 1, "checkpoint-1.pth's step, epoch")
            got = resumed[0]
            check(got["model"].keys() == blob["model"].keys()
                  and all(torch.equal(got["model"][k], v) for k, v in blob["model"].items()),
                  "the resumed model is not checkpoint-1.pth's")
            saved = blob["optimizer"]["state"]
            check(got["optimizer"].keys() == saved.keys()
                  and all(torch.equal(got["optimizer"][i][k], v.to(got["optimizer"][i][k].device))
                          for i, st in saved.items() for k, v in st.items()),
                  "the resumed AdamW moments are not checkpoint-1.pth's")
            lr3, _, _ = B.build_lr_schedules(args3, spe)
            check(steps[0]["step"] == n_steps and steps[0]["metrics"]["lr"] == lr3(n_steps),
                  f"the resumed run's first step {steps[0]['step']} lr {steps[0]['metrics']['lr']}"
                  f", the schedule's at update {n_steps} {lr3(n_steps)}")
            n_opt = sum(len(st) for st in saved.values())
            print(f"  --epochs 3 resumed at epoch {got['epoch']}, step {got['step']}: "
                  f"{len(got['model'])} model tensors and {n_opt} AdamW tensors equal to "
                  f"checkpoint-1.pth's, first lr {steps[0]['metrics']['lr']:.6e} = the schedule's "
                  f"at update {n_steps}; launches {paths['cli_train_resume']}", flush=True)
            finite_metrics(steps, "resumed")
            with open(os.path.join(out, "log.txt")) as f:
                check([json.loads(line)["epoch"] for line in f] == [0, 1, 2], "log.txt epochs")
            del state, blob, got
            prof = profiled.pop("prof")
            busy_ms, idle, top = trace_summary(prof)
            wall_ms = profiled["wall_ms"]
            rate3 = spe * bs / (evals[0]["t"] - steps[0]["t"])
            print(f"  profiled driver steps {profiled['start']} and {profiled['start'] + 1} (the "
                  f"card synchronized at both ends, the loader, transform, readback and host "
                  f"between): wall {wall_ms:.2f} ms, CUDA kernel and copy time {busy_ms:.2f} ms, "
                  f"busy share {busy_ms / wall_ms:.3f}; the card idle (ms) "
                  f"{json.dumps({k: round(v, 2) for k, v in idle.items()})} before its first "
                  f"kernel, between, after its last; top kernels (ms): {json.dumps(top)}; this "
                  f"epoch's rate with the profiler on {rate3:.1f} img/s, without it (epoch 1 "
                  f"above) {rates[1]:.1f}: the trace's device time a step against the unprofiled "
                  f"step, {busy_ms / 2:.2f} / {bs * 1000 / rates[1]:.2f} ms = "
                  f"{busy_ms / 2 * rates[1] / (bs * 1000):.3f}", flush=True)

            # --- --quant int8: one epoch of 2 steps and its evaluation
            steps.clear()
            evals.clear()
            reset_kernel_counts(FA, TQ, DO)
            state = FT.main(args_of(os.path.join(tmp, "int8"), "--quant", "int8", "--epochs", "1",
                                    "--steps_per_epoch", "2", "--no_save_ckpt",
                                    "--no_auto_resume"))
            torch.cuda.synchronize()
            paths["cli_train_int8"] = kernel_counts(FA, TQ, DO)
            print(f"  --quant int8, 2 steps: launches {paths['cli_train_int8']}; losses "
                  + ", ".join(f"{float(r['metrics']['loss']):.4f}" for r in steps), flush=True)
            for r in steps:
                check(r["launches"] == dict(want, K1=depth, K2=depth, K6=8 * depth, K7=4 * depth),
                      f"int8 step {r['step']} launched {r['launches']}")
            expect = dict(want, K1=depth * (2 + eval_fwd), K2=depth * 2,
                          K6=8 * depth * 2 + 4 * depth * eval_fwd, K7=4 * depth * 2)
            check(len(steps) == 2 and paths["cli_train_int8"] == expect,
                  f"the int8 run launched {paths['cli_train_int8']}, expected {expect}")
            finite_metrics(steps, "int8")
            del state
    finally:
        FT.make_finetune_train_step, FT.E.evaluate, FT.C.auto_load = make_step, evaluate, auto_load
        if "prof" in profiled:
            profiled.pop("prof").stop()
        FA.BOUNDED_SCORES = bounded
    return paths


# Phase 18: the elem and pair mixes on the card against the CPU's on the same
# draws: the same f32 products of the same operands, in the same order.
MIX_ATOL = 1e-6


@contextlib.contextmanager
def watched_driver(torch, FT, counts, sync_step=None):
    """Inside, each call of the driver's train step and evaluate() is
    recorded (host clock, launches by ``counts()``, metrics; the first
    step's gradient norms by leaf; whether the first two steps moved the
    parameters), and the step of state step ``sync_step`` runs under
    torch.cuda.set_sync_debug_mode("error")."""
    rec = {"steps": [], "evals": [], "sync_checked": False}
    make_step, evaluate = FT.make_finetune_train_step, FT.E.evaluate

    def recording_make_step(model, *a, **k):
        step = make_step(model, *a, **k)

        def recorded(state, *args):
            i = len(rec["steps"])
            before = counts()
            params = ([p.detach().clone() for p in model.parameters()] if i < 2 else None)
            checked = state.step == sync_step
            t = time.perf_counter()
            if checked:
                torch.cuda.set_sync_debug_mode("error")
            try:
                m = step(state, *args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            rec["sync_checked"] = rec["sync_checked"] or checked
            after = counts()
            r = {"step": state.step - 1, "t": t, "metrics": m,
                 "launches": {k: after[k] - before[k] for k in after}}
            if i == 0:  # the mini-step's own gradients, after any group sum
                r["grad_norms"] = leaf_grad_norms(torch, model)
            if params is not None:
                r["moved"] = any(not torch.equal(p, q) for p, q in zip(params, model.parameters()))
            rec["steps"].append(r)
            rec["model"] = model
            return m

        return recorded

    def timed_evaluate(*a, **k):
        torch.cuda.synchronize()
        before = counts()
        t = time.perf_counter()
        out = evaluate(*a, **k)
        torch.cuda.synchronize()
        after = counts()
        rec["evals"].append({"t": t, "ms": (time.perf_counter() - t) * 1000,
                             "launches": {k: after[k] - before[k] for k in after}})
        return out

    FT.make_finetune_train_step, FT.E.evaluate = recording_make_step, timed_evaluate
    try:
        yield rec
    finally:
        FT.make_finetune_train_step, FT.E.evaluate = make_step, evaluate


def cli7c_seq_rank(group, device, train_argv, eval_argv):
    """One rank of phase 18b: the driver's body (``cli.finetune.run_rank``, what
    ``main`` runs on each rank under --seq_parallel) trains, then evaluates,
    with this rank's half of the tokens on the one card. Returns its
    launches, its steps' losses, grad norms and host times, step 0's leaf
    gradient norms and a digest of its parameters."""
    import torch

    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA

    def counts():
        return {**attention_counts(FA), **cross_counts(FA)}

    def reset():
        reset_attention_counts(FA)
        reset_cross_counts(FA)

    out = {}
    with watched_driver(torch, FT, counts) as rec:
        reset()
        FT.run_rank(group, FT.get_args_parser().parse_args(train_argv), device)
        torch.cuda.synchronize()
        out["train"] = counts()
        steps = rec["steps"]
        out["steps"] = [(float(r["metrics"]["loss"]), float(r["metrics"]["grad_norm"]))
                        for r in steps]
        out["step_launches"] = [r["launches"] for r in steps]
        out["grad_norms"] = steps[0]["grad_norms"]
        out["step_ms"] = [(b["t"] - a["t"]) * 1000 for a, b in zip(steps, steps[1:])]
        out["digest"] = [float(p.detach().double().sum()) for p in rec["model"].parameters()]
        del rec["model"]
        reset()
        t = time.perf_counter()
        FT.run_rank(group, FT.get_args_parser().parse_args(eval_argv), device)
        torch.cuda.synchronize()
        out["eval_s"] = time.perf_counter() - t
        out["evaluate"] = counts()
    return out


def phase18(torch, FA, dev, step_rates):
    """Slice 7c's driver on the card: ViT-B/16 384 trained from a 224 .pth
    with gradient accumulation, token masking and elem / pair mixup on
    cutmix_minmax boxes (18a), the same over two gloo ranks (18b), and
    ViT-L/16 384 evaluated (18c). step_rates: phase 4's step-only img/s."""
    import tempfile

    import numpy as np

    from uncertainty_vit_tpu_torch.cli import builders as B
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
    from uncertainty_vit_tpu_torch.evals.collect import collect_logits
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import mixup as TM
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.parallel import seq

    n_train, n_test, bs, depth, spe, n_tok = 128, 64, 32, 12, 4, 577
    rs = np.random.RandomState(18)
    train_images = rs.randint(0, 256, (n_train, 32, 32, 3), dtype=np.uint8)
    test_images = rs.randint(0, 256, (n_test, 32, 32, 3), dtype=np.uint8)
    base = dict(num_classes=100, use_shared_rel_pos_bias=True, use_abs_pos_emb=False,
                init_values=0.1)

    def counts():
        # inside attention_on_plain the attention wrappers are plain
        # functions, which count nothing
        return kernel_counts(FA, TQ, DO) if hasattr(FA.fused_qkv_attention_bwd, "launches") else {}

    def card():
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()

    want = {k: 0 for k in counts()}
    paths = {}
    bounded = FA.BOUNDED_SCORES
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_cifar100(tmp, train_images, np.arange(n_train) % 100, "train")
            write_cifar100(tmp, test_images, np.arange(n_test) % 100, "test")
            pth = os.path.join(tmp, "vitb224.pth")
            write_vitb_pth(torch, dev, get_preset("beit_base_patch16_224", **base), pth, 180)

            def argv(out_dir, *extra, model="beit_base_patch16_384", finetune=pth):
                return ["--model", model, "--input_size", "384", "--data_set", "CIFAR100",
                        "--data_path", tmp, "--num_workers", "8", "--finetune", finetune,
                        "--output_dir", os.path.join(tmp, out_dir), "--layer_decay", "0.65",
                        "--drop_path", "0.1", "--warmup_epochs", "0", "--no_auto_resume", *extra]

            flags_7c = ["--update_freq", "2", "--masked_position_prob", "0.1"]
            mix = ["--mixup_mode", "elem", "--cutmix_minmax", "0.2", "0.8"]

            # --- 18a: one epoch of 4 mini-steps (2 updates) and its evaluation
            args = FT.get_args_parser().parse_args(argv(
                "a", "--batch_size", str(bs), "--epochs", "1", "--steps_per_epoch", str(spe),
                "--no_save_ckpt", *flags_7c, *mix))
            with watched_driver(torch, FT, counts, sync_step=3) as rec:
                reset_kernel_counts(FA, TQ, DO)
                t0 = time.perf_counter()
                state = FT.main(args)
                torch.cuda.synchronize()
                main_s = time.perf_counter() - t0
                paths["cli7c_train"] = counts()
                run, evals = list(rec["steps"]), list(rec["evals"])
                rec.pop("model")
                del state
            print(f"  18a ViT-B/16 384 from a 224 .pth, {spe} mini-steps at batch {bs}, "
                  f"--update_freq 2, --masked_position_prob 0.1, elem mixup on cutmix_minmax "
                  f"(0.2, 0.8) boxes: launches {paths['cli7c_train']}", flush=True)
            eval_fwd = n_test // bs
            expect = dict(want, K3=depth * (spe + eval_fwd), K4=depth * spe)
            check(paths["cli7c_train"] == expect,
                  f"18a launched {paths['cli7c_train']}, expected {expect}")
            check(len(run) == spe and len(evals) == 1, f"{len(run)} steps, {len(evals)} evals")
            for r in run:
                check(r["launches"] == dict(want, K3=depth, K4=depth),
                      f"18a mini-step {r['step']} launched {r['launches']}")
                check(all(math.isfinite(float(r["metrics"][k])) for k in ("loss", "grad_norm")),
                      f"18a mini-step {r['step']}: {r['metrics']}")
            check(evals[0]["launches"] == dict(want, K3=depth * eval_fwd),
                  f"18a's evaluation launched {evals[0]['launches']}")
            check(not run[0]["moved"] and run[1]["moved"],
                  f"the parameters moved after mini-step 0: {run[0]['moved']}, after "
                  f"mini-step 1: {run[1]['moved']} (expected unchanged, then changed)")
            lr, _, _ = B.build_lr_schedules(args, spe)
            check([r["metrics"]["lr"] for r in run] == [lr(i // 2) for i in range(spe)],
                  "18a's lr is not read at the update index")
            check(rec["sync_checked"], "the step under sync debug mode did not run")
            print(f"  mini-step 0 left the parameters as they were, mini-step 1 moved them; "
                  f"mini-step 3 ran with torch.cuda.set_sync_debug_mode('error'); losses "
                  + ", ".join(f"{float(r['metrics']['loss']):.4f}" for r in run)
                  + "; grad norms " + ", ".join(f"{float(r['metrics']['grad_norm']):.4f}"
                                                 for r in run), flush=True)
            rate = (spe - 1) * bs / (evals[0]["t"] - run[1]["t"])
            print(f"  18a rate (information only; {card()}; host clock from mini-step 1 to the "
                  f"end of mini-step 3): {rate:.1f} img/s, {rate * n_tok:.0f} tokens/s; phase 4's "
                  f"ViT-B/16 224 step alone in this call: "
                  f"{[round(r * 197) for r in step_rates['kernel']]} tokens/s; its evaluation "
                  f"of {n_test} images {evals[0]['ms']:.2f} ms; main() {main_s:.2f} s",
                  flush=True)

            # mini-step 0 on the plain attention: the same flags, state and draws
            with watched_driver(torch, FT, counts) as rec:
                reset_kernel_counts(FA, TQ, DO)
                with attention_on_plain(torch, FA):
                    FT.main(FT.get_args_parser().parse_args(argv(
                        "plain", "--batch_size", str(bs), "--epochs", "1", "--steps_per_epoch",
                        "1", "--no_save_ckpt", "--disable_eval_during_finetuning", *flags_7c,
                        *mix)))
                torch.cuda.synchronize()
                check(counts() == want, "the plain-attention run launched a kernel")
                m_p = rec["steps"][0]["metrics"]
                rec.pop("model")
            m_k = run[0]["metrics"]
            loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
            gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
            print(f"  18a mini-step 0, kernels vs plain attention: loss {loss_k:.6f} / "
                  f"{loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
            check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
                  "18a's first loss disagrees with the plain attention's")
            check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
                  "18a's first grad norm disagrees with the plain attention's")

            # then a 2-step --mixup_mode pair epoch
            with watched_driver(torch, FT, counts) as rec:
                reset_kernel_counts(FA, TQ, DO)
                FT.main(FT.get_args_parser().parse_args(argv(
                    "pair", "--batch_size", str(bs), "--epochs", "1", "--steps_per_epoch", "2",
                    "--no_save_ckpt", "--disable_eval_during_finetuning", *flags_7c,
                    "--mixup_mode", "pair", "--cutmix_minmax", "0.2", "0.8")))
                torch.cuda.synchronize()
                paths["cli7c_train_pair"] = counts()
                pair_steps = rec["steps"]
                rec.pop("model")
            print(f"  18a --mixup_mode pair, 2 mini-steps: launches "
                  f"{paths['cli7c_train_pair']}; losses "
                  + ", ".join(f"{float(r['metrics']['loss']):.4f}" for r in pair_steps),
                  flush=True)
            check(paths["cli7c_train_pair"] == dict(want, K3=2 * depth, K4=2 * depth),
                  f"the pair epoch launched {paths['cli7c_train_pair']}")
            check(all(math.isfinite(float(r["metrics"]["loss"])) for r in pair_steps),
                  "the pair epoch's losses")

            # the elem and pair mixes on the card against the CPU's, same draws
            gen = torch.Generator(device=dev).manual_seed(181)
            x = torch.randn(bs, 384, 384, 3, generator=gen, device=dev)
            y = torch.randint(0, 100, (bs,), generator=gen, device=dev)
            mix_ms = {}
            for mode in ("elem", "pair"):
                count = bs if mode == "elem" else bs // 2
                draws = TM.draw_mixup_elem(torch.Generator().manual_seed(182), count, 384, 384,
                                           0.8, 1.0, 1.0, 0.5, (0.2, 0.8))
                if mode == "pair":
                    draws = draws.mirrored()
                on_card = TM.mix_elem(x, y, 100, 0.1, draws)
                on_cpu = TM.mix_elem(x.cpu(), y.cpu(), 100, 0.1, draws)
                diffs = [(a.cpu() - b).abs().max().item() for a, b in zip(on_card, on_cpu)]
                mix_ms[mode] = cuda_ms(lambda: TM.mix_elem(x, y, 100, 0.1, draws), 10)
                print(f"  {mode} mix [{bs}, 384, 384, 3] on the card vs the CPU on the same "
                      f"draws: images max|diff| {diffs[0]:.3e}, targets {diffs[1]:.3e} (bound "
                      f"{MIX_ATOL}); {mix_ms[mode]:.3f} ms on the card (CUDA events)", flush=True)
                check(max(diffs) <= MIX_ATOL,
                      f"the {mode} mix on the card disagrees with the CPU's")
            del x, y, on_card, on_cpu

            # --- 18b: the same over two gloo ranks sharing the card, without mixup
            bs_seq = 8
            seq_flags = ["--batch_size", str(bs_seq), "--mixup", "0", "--cutmix", "0", *flags_7c]
            train_argv = argv("seq", *seq_flags, "--epochs", "1", "--steps_per_epoch", "2",
                              "--disable_eval_during_finetuning", "--save_ckpt_freq", "1",
                              "--seq_parallel", "2")
            eval_argv = argv("seq_eval", "--batch_size", str(bs_seq), "--eval",
                             "--seq_parallel", "2")
            # the unsharded driver's step 0 on the same batch and draws
            with watched_driver(torch, FT, counts) as rec:
                FT.main(FT.get_args_parser().parse_args(argv(
                    "ref", *seq_flags, "--epochs", "1", "--steps_per_epoch", "1",
                    "--disable_eval_during_finetuning", "--no_save_ckpt")))
                ref = rec["steps"][0]
                rec.pop("model")
            ref_loss, ref_norms = float(ref["metrics"]["loss"]), ref["grad_norms"]
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = seq.run_ranks(cli7c_seq_rank, 2, str(dev), train_argv, eval_argv,
                                  timeout=600.0)
            secs = time.perf_counter() - t0
            for r, res in enumerate(ranks):
                print(f"  18b rank {r}: train launches {res['train']}, --eval launches "
                      f"{res['evaluate']}; losses, grad norms {res['steps']}", flush=True)
                check(res["train"] == dict(K1=0, K2=0, K3=0, K4=0, K5=2 * depth,
                                           K5_bwd=2 * depth),
                      f"18b rank {r}'s 2 steps launched {res['train']}")
                fwd = n_test // bs_seq
                check(res["evaluate"] == dict(K1=0, K2=0, K3=0, K4=0, K5=depth * fwd, K5_bwd=0),
                      f"18b rank {r}'s --eval launched {res['evaluate']}")
                check(all(math.isfinite(l) and math.isfinite(g) for l, g in res["steps"]),
                      f"18b rank {r}'s losses")
            a, b = ranks
            check(a["steps"] == b["steps"] and a["grad_norms"] == b["grad_norms"],
                  "the two ranks' losses or gradients differ")
            check(a["digest"] == b["digest"], "the two ranks' parameters differ after the steps")
            loss = a["steps"][0][0]
            rel = {k: abs(a["grad_norms"][k] - v) / v if v > 0 else float(a["grad_norms"][k] != 0)
                   for k, v in ref_norms.items()}
            worst = max(rel, key=rel.get)
            print(f"  18b step 0 vs the unsharded driver's: loss {loss:.6f} / {ref_loss:.6f}; "
                  f"worst leaf {worst} relative {rel[worst]:.3e} (bound {LEAF_GRAD_REL_BOUND}), "
                  f"median {sorted(rel.values())[len(rel) // 2]:.3e} of {len(rel)}; parameters "
                  f"equal on both ranks after the steps", flush=True)
            check(list(a["grad_norms"]) == list(ref_norms), "18b's leaves")
            check(abs(loss - ref_loss) <= LOSS_REL_BOUND * abs(ref_loss),
                  "18b's step 0 loss disagrees with the unsharded driver's")
            check(rel[worst] <= LEAF_GRAD_REL_BOUND,
                  f"18b's gradient of {worst} disagrees with the unsharded driver's")
            out_seq = os.path.join(tmp, "seq")
            with open(os.path.join(out_seq, "log.txt")) as f:
                log = [json.loads(line) for line in f]
            check([r["epoch"] for r in log] == [0], f"18b's log.txt: {log} (one rank writes)")
            check({"checkpoint-0.pth"} <= set(os.listdir(out_seq)), "18b's checkpoint-0.pth")
            check(not os.path.exists(os.path.join(tmp, "seq_eval", "log.txt")),
                  "--eval wrote a log")
            paths["cli7c_seq2_train"] = {k: a["train"][k] + b["train"][k] for k in a["train"]}
            paths["cli7c_seq2_evaluate"] = {k: a["evaluate"][k] + b["evaluate"][k]
                                            for k in a["evaluate"]}
            print(f"  18b (information only: two ranks share one card over gloo; {card()}) "
                  f"step ms {[round(ms, 2) for ms in a['step_ms']]} on rank 0 at batch {bs_seq}; "
                  f"--eval of {n_test} images {a['eval_s']:.2f} s; the ranks ran {secs:.1f} s from "
                  f"start to end", flush=True)

            # --- 18c: ViT-L/16 384 --eval from a ViT-L/16 224 .pth at batch 16
            lpth = os.path.join(tmp, "vitl224.pth")
            write_vitb_pth(torch, dev, get_preset("beit_large_patch16_224", **base), lpth, 183)
            largs = FT.get_args_parser().parse_args(argv(
                "large", "--batch_size", "16", "--eval", model="beit_large_patch16_384",
                finetune=lpth))
            reset_kernel_counts(FA, TQ, DO)
            t0 = time.perf_counter()
            res = FT.main(largs)["eval"]
            torch.cuda.synchronize()
            large_s = time.perf_counter() - t0
            paths["cli7c_large_evaluate"] = counts()
            check(paths["cli7c_large_evaluate"] == dict(want, K3=24 * n_test // 16),
                  f"18c launched {paths['cli7c_large_evaluate']}")
            check(all(math.isfinite(v) for v in res.values()), f"18c's metrics {res}")
            model, cfg = FT.build_model(largs, 100, dev)
            FT.load_variables(largs, model)
            loader, _ = B.build_loaders(largs, is_train=False)
            first = [next(iter(FT._eval_batches(loader, largs, dev)))]
            logits, _ = collect_logits(make_eval_forward(model), first)
            plain = VisionTransformer(cfg.replace(use_flash_attention=False),
                                      dtype=torch.bfloat16, device=dev)
            plain.load_state_dict(model.state_dict())
            ref_logits, _ = collect_logits(make_eval_forward(plain), first)
            del plain, model
            diff, scale = float(np.abs(logits - ref_logits).max()), float(np.abs(ref_logits).max())
            print(f"  18c ViT-L/16 384 --eval over {n_test} images at batch 16 ({card()}): "
                  f"launches {paths['cli7c_large_evaluate']}; {json.dumps(res)}; logits vs the "
                  f"plain attention's: max|diff| {diff:.3e}, max|logit| {scale:.3e}, ratio "
                  f"{diff / scale:.3e} (bound {LOGIT_REL_BOUND}); main() {large_s:.2f} s",
                  flush=True)
            check(logits.shape == (16, 100) and diff <= LOGIT_REL_BOUND * scale,
                  "18c's logits disagree with the plain attention's")
    finally:
        FA.BOUNDED_SCORES = bounded
    return paths


# Phase 19: the SNGP precision matrix after the driver's steps against a
# float64 CPU recomputation from the pooled features the card produced (the
# card forms φ and φᵀφ in f32 from the same features and parameters), relative
# to its largest entry; the spectral estimate σ = u·(W_n v) of the normalised
# fc_norm weight against the bound 0.95 (exactly 0.95 when it rescaled, in
# f64 from the f32 buffers).
PRECISION_REL_BOUND = 1e-4
SIGMA_ATOL = 1e-5
# The Laplace fit and predictive on the card against a float64 CPU
# recomputation from the card's features: the factor sums A = Σ φ̃φ̃ᵀ and
# G = Σ diag(p) − ppᵀ (through the card's eigendecompositions, relative to
# their largest entries: f32 sums of 256 terms) and the predictive
# log-probabilities on the card's factors (the mc draw depends on the
# eigenvectors, and an f32 eigh moves the small eigenvalues of G and of a
# rank-deficient A by ~1e-7 of the largest, which a float64 refit does not
# share: its difference is printed, not bounded).
LAPLACE_FACTOR_RTOL = 1e-5
LAPLACE_ATOL = 1e-4
# The mc link's draws f + Q_G(√s ⊙ ε) reach |f| ~ 1e3 where the prior
# precision is small (s of the G eigenvector 1/√C is |φ̃|²/τ; it shifts every
# class alike and cancels in the softmax, not in f32): the log-probabilities
# are held within LAPLACE_ATOL plus 2^-17 (64 f32 ulps) of the largest draw.
LAPLACE_MC_DRAW_RTOL = 2.0**-17
# T*: a point of fit_temperature's final grid; where the fit set's NLL is flat
# at its minimum, the card's f32 curve and the CPU's may pick other points.
# The card's T* must then be as good a minimizer on the CPU: its NLL there
# within TEMP_NLL_RTOL of the NLL at the CPU's own T*.
TEMP_NLL_RTOL = 1e-5


def laplace_f64(np, feats_fit, logits_fit, feats, logits, tau, link, eps=None, factors=None):
    """The last-layer KFAC Laplace predictive in float64 on the CPU: the fit
    (A = Σ φ̃φ̃ᵀ, G = Σ diag(p) − ppᵀ, their eigendecompositions) unless
    ``factors`` = (q_a, a, q_g, g, n) are given, then the GLM predictive's
    log-probabilities at prior precision tau, link probit or mc (draws eps
    [S, B, C])."""
    def aug(f):
        f = np.asarray(f, np.float64)
        return np.concatenate([f, np.ones((len(f), 1))], axis=1)

    def log_softmax(x):
        x = x - x.max(axis=-1, keepdims=True)
        return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))

    if factors is None:
        phi = aug(feats_fit)
        p = np.exp(log_softmax(np.asarray(logits_fit, np.float64)))
        a, q_a = np.linalg.eigh(phi.T @ phi)
        g, q_g = np.linalg.eigh(np.diag(p.sum(0)) - p.T @ p)
        factors = (q_a, np.clip(a, 0, None), q_g, np.clip(g, 0, None), len(phi))
    q_a, a, q_g, g, n = (np.asarray(f, np.float64) if i < 4 else f for i, f in enumerate(factors))
    s = (aug(feats) @ q_a) ** 2 @ (1.0 / (np.outer(g, a) / n + tau)).T
    logits = np.asarray(logits, np.float64)
    if link == "probit":
        var = s @ (q_g ** 2).T
        return log_softmax(logits / np.sqrt(1.0 + math.pi / 8.0 * var))
    draws = logits[None] + (np.sqrt(s)[None] * np.asarray(eps, np.float64)) @ q_g.T
    lp = log_softmax(draws)
    m = lp.max(axis=0)
    return m + np.log(np.exp(lp - m).sum(axis=0)) - math.log(len(lp))


def phase19(torch, FA, dev):
    """Slice 8 through the finetune driver on the card, ViT-B/16 224 at full
    width and depth with a 100-class head from its .pth, over seeded 32x32
    CIFAR-100 images: (a) --sngp training, (b) --het_layer training and
    evaluation, (c) the post-hoc evaluations (--temp_scaling, --laplace,
    --corrupted_data, --perturbed_data, --visualize_embedding). Returns the
    launches of each path."""
    import tempfile

    import numpy as np

    from uncertainty_vit_tpu_torch.cli import builders as B
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.data import datasets as D
    from uncertainty_vit_tpu_torch.evals import calibration as CAL
    from uncertainty_vit_tpu_torch.evals import laplace as LA
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals import robustness as R
    from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
    from uncertainty_vit_tpu_torch.evals.collect import collect_logits, per_call_generator
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.ops.augment import eval_transform_batch

    depth, bs_train, bs, spe = 12, 160, 128, 4
    # the post-hoc fits take more images than the pooled feature's 768 + 1
    # dimensions: below that the Laplace factor A is singular, the mc link's
    # draws saturate into one-hot softmaxes, and their ties make the AUROC
    # depend on the device's rounding
    n_train, n_test, n_big, n_fit = 640, 256, 1024, 1024
    n_c, n_vid, n_frames = 5 * 64, 16, 8
    distortions, perturbations = ("gaussian_noise", "frost", "pixelate"), ("shot_noise", "tilt")
    rs = np.random.RandomState(19)

    def u8(n, *shape):
        return rs.randint(0, 256, (n,) + shape, dtype=np.uint8)

    cfg = get_preset("beit_base_patch16_224", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    width = cfg.embed_dim

    def counts():
        # inside attention_on_plain the attention wrappers are plain
        # functions, which count nothing
        return kernel_counts(FA, TQ, DO) if hasattr(FA.fused_qkv_attention_bwd, "launches") else {}

    want = {k: 0 for k in counts()}
    paths = {}

    def counted(path, expect, fn, *a, **k):
        """fn(*a, **k) with the counts set to 0 before and read after, held
        to ``expect`` (the kernels not named: 0)."""
        reset_kernel_counts(FA, TQ, DO)
        out = fn(*a, **k)
        torch.cuda.synchronize()
        paths[path] = counts()
        exp = dict(want, **expect)
        print(f"  {path}: launches {paths[path]}", flush=True)
        check(paths[path] == exp, f"{path} launched {paths[path]}, expected {exp}")
        return out

    def held_metrics(got, logits, labels, what, extra=(), probs=None, skip=()):
        """Printed metrics against the same metrics of these logits
        recomputed on the CPU; with ``probs`` the CPU's metrics read those
        softmax probabilities in place of their own. Keys in ``skip`` are
        not compared."""
        softmax = M.softmax_probs
        if probs is not None:
            M.softmax_probs = lambda _: probs
        try:
            ref = {k: float(v) for k, v in M.classification_metrics(
                torch.from_numpy(np.asarray(logits, np.float32)),
                torch.from_numpy(np.asarray(labels))).items()}
        finally:
            M.softmax_probs = softmax
        ref["loss"] = ref["nll"]
        keys = sorted(set(got) - set(extra))
        check(keys == sorted(ref), f"{what} metric keys {keys}")
        for k, v in ref.items():
            if k not in skip:
                check(abs(got[k] - v) <= METRIC_ATOL + METRIC_RTOL * abs(v),
                      f"{what} metric {k}: printed {got[k]}, recomputed on the CPU {v}")
        return ref

    def card():
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()

    bounded, perturbation_list = FA.BOUNDED_SCORES, R.PERTURBATIONS
    try:
        with tempfile.TemporaryDirectory() as tmp:
            d_train, d_eval, d_big = (os.path.join(tmp, n) for n in ("train", "eval", "big"))
            write_cifar100(d_train, u8(n_train, 32, 32, 3), np.arange(n_train) % 100, "train")
            write_cifar100(d_train, u8(n_test, 32, 32, 3), np.arange(n_test) % 100, "test")
            write_cifar100(d_big, u8(n_big, 32, 32, 3), np.arange(n_big) % 100, "test")
            croot, proot = os.path.join(tmp, "cifar-c"), os.path.join(tmp, "cifar-p")
            os.makedirs(croot)
            os.makedirs(proot)
            # 5 severities x 64 images each in the file's order; the
            # 10,000-rows-a-severity layout (load_cifar_c) reads them all as
            # severity 1
            np.save(os.path.join(croot, "labels.npy"), np.arange(n_c) % 100)
            for name in distortions:
                np.save(os.path.join(croot, f"{name}.npy"), u8(n_c, 32, 32, 3))
            for name in perturbations:
                np.save(os.path.join(proot, f"{name}.npy"), u8(n_vid, n_frames, 32, 32, 3))
            pth = os.path.join(tmp, "vitb.pth")
            write_vitb_pth(torch, dev, cfg, pth, 190)
            # the post-hoc evaluations' split: labels the .pth's own class for
            # four images in five and another class for the fifth, so that it
            # is right about 80% of the time and T* and the Laplace prior
            # fall inside their grids (random labels would drive T* to the
            # grid's top)
            fit_u8, test_u8 = u8(n_fit, 32, 32, 3), u8(n_test, 32, 32, 3)
            vit = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev)
            vit.load_state_dict(torch.load(pth, map_location=dev, weights_only=False)["model"])
            for split, x in (("train", fit_u8), ("test", test_u8)):
                fwd = make_eval_forward(vit)
                pred = torch.cat([fwd(eval_transform_batch(torch.from_numpy(x[i:i + bs]).to(dev),
                                                           224, 224 / 256)).argmax(-1)
                                  for i in range(0, len(x), bs)]).cpu().numpy()
                wrong = (pred + 1 + np.arange(len(x)) % 99) % 100
                write_cifar100(d_eval, x, np.where(np.arange(len(x)) % 5 == 4, wrong, pred), split)
            del vit

            def args_of(root, out, *extra):
                return FT.get_args_parser().parse_args([
                    "--model", "beit_base_patch16_224", "--input_size", "224",
                    "--data_set", "CIFAR100", "--data_path", root, "--num_workers", "8",
                    "--finetune", pth, "--output_dir", os.path.join(tmp, out), *extra])

            def train_args(out, *extra):
                return args_of(d_train, out, "--batch_size", str(bs_train), "--save_ckpt_freq",
                               "1", "--layer_decay", "0.65", "--drop_path", "0.1", *extra)

            def eval_args(root, *extra):
                return args_of(root, "eval_out", "--batch_size", str(bs), "--eval", *extra)

            # ---------------- 19a: --sngp training ----------------
            t19 = time.perf_counter()
            # each SNGP head forward that updates the precision matrix: its
            # input, its input norm's parameters and the matrix it found
            records = []
            make_step = FT.make_finetune_train_step

            def hooking_make_step(model, *a, **k):
                def record(mod, args, kwargs):
                    if kwargs.get("update_cov"):
                        ln = mod._gp_input_normalize_layer
                        records.append((args[0].detach().float().clone(), ln.weight.detach().clone(),
                                        ln.bias.detach().clone(),
                                        mod.precision_matrix.detach().clone()))

                model.head.register_forward_pre_hook(record, with_kwargs=True)
                return make_step(model, *a, **k)

            FT.make_finetune_train_step = hooking_make_step
            try:
                with watched_driver(torch, FT, counts) as rec:
                    state = counted(
                        "cli8_sngp_train", {"K1": depth * (spe + 2), "K2": depth * spe}, FT.main,
                        train_args("sngp", "--sngp", "--epochs", "1", "--steps_per_epoch",
                                   str(spe)))
                    steps1 = list(rec["steps"])
                    rec.pop("model")
                for r in steps1:
                    check(r["launches"] == dict(want, K1=depth, K2=depth),
                          f"SNGP step {r['step']} launched {r['launches']}")
                    check(math.isfinite(float(r["metrics"]["loss"])), "SNGP loss")
                model = state.model
                head = model.head
                check(len(records) == spe, f"{len(records)} SNGP head updates, expected {spe}")
                ridge = 1e-3 * np.eye(width)
                check(np.array_equal(records[0][3].cpu().numpy(), ridge.astype(np.float32)),
                      "the SNGP precision matrix did not start at ridge·I")
                wrf = head._random_feature.weight.double().cpu().numpy()
                brf = head._random_feature.bias.double().cpu().numpy()

                def phi64(feat, w, b):
                    x = feat.double().cpu().numpy()
                    x = (x - x.mean(1, keepdims=True)) / np.sqrt(x.var(1, keepdims=True) + 1e-12)
                    x = x * w.double().cpu().numpy() + b.double().cpu().numpy()
                    return np.cos(x @ wrf.T + brf)

                p64 = ridge.copy()
                for feat, w, b, _ in records:
                    phi = phi64(feat, w, b)
                    p64 = 0.999 * p64 + 0.001 * (phi.T @ phi) / len(phi)
                p_card = head.precision_matrix.double().cpu().numpy()
                perr = float(np.abs(p_card - p64).max())
                print(f"  19a precision matrix after {spe} steps vs a float64 CPU recomputation "
                      f"from the card's pooled features: max|diff| {perr:.3e}, max|P| "
                      f"{np.abs(p64).max():.3e} (bound {PRECISION_REL_BOUND} of it)", flush=True)
                check(perr <= PRECISION_REL_BOUND * np.abs(p64).max(),
                      "the SNGP precision matrix disagrees with the CPU's recomputation")
                sn = model.fc_norm
                u, v, w = sn.weight_u.double(), sn.weight_v.double(), sn.weight_orig.double()
                w_n = w * min(1.0, 0.95 / float(u @ (w @ v)))  # the weight the forward applies
                sigma = float(u @ (w_n @ v))
                true_sigma = float(torch.linalg.matrix_norm(w_n, 2))
                print(f"  19a spectral fc_norm: |u| {float(u.norm()):.7f}, |v| {float(v.norm()):.7f}"
                      f", sigma = u.(W_n v) {sigma:.7f} (bound 0.95 + {SIGMA_ATOL}); the "
                      f"normalised weight's largest singular value {true_sigma:.5f} (information: "
                      f"{spe} power iterations from a random start)", flush=True)
                check(abs(float(u.norm()) - 1) <= 1e-6 and abs(float(v.norm()) - 1) <= 1e-6,
                      "u or v is not of unit norm")
                check(sigma <= 0.95 + SIGMA_ATOL, f"sigma {sigma} above the bound")
                blob = torch.load(os.path.join(tmp, "sngp", "checkpoint-0.pth"),
                                  map_location="cpu", weights_only=False)
                check(all(torch.equal(v_.cpu(), blob["model"][k])
                          for k, v_ in model.state_dict().items()),
                      "checkpoint-0.pth is not the trained model's state")
                del state, model, head, sn

                # step 0 on the plain attention: the same flags, state and draws
                with watched_driver(torch, FT, counts) as rec:
                    reset_kernel_counts(FA, TQ, DO)
                    with attention_on_plain(torch, FA):
                        FT.main(train_args("sngp_plain", "--sngp", "--epochs", "1",
                                           "--steps_per_epoch", "1", "--no_save_ckpt",
                                           "--disable_eval_during_finetuning", "--no_auto_resume"))
                    torch.cuda.synchronize()
                    check(counts() == want, "the plain-attention run launched a kernel")
                    m_p = rec["steps"][0]["metrics"]
                    rec.pop("model")
                m_k = steps1[0]["metrics"]
                loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
                gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
                print(f"  19a step 0, kernels vs plain attention: loss {loss_k:.6f} / "
                      f"{loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
                check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
                      "19a's first loss disagrees with the plain attention's")
                check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
                      "19a's first grad norm disagrees with the plain attention's")

                # --sngp_cov_momentum 0, --epochs 2: auto-resumes from
                # checkpoint-0.pth and restarts the precision matrix at epoch 1
                records.clear()
                state = counted(
                    "cli8_sngp_exact_resume", {"K1": depth * (2 + 2), "K2": depth * 2}, FT.main,
                    train_args("sngp", "--sngp", "--epochs", "2", "--steps_per_epoch", "2",
                               "--sngp_cov_momentum", "0"))
                head = state.model.head
                check(state.step == spe + 2 and len(records) == 2, f"resumed state step "
                      f"{state.step}, {len(records)} head updates")
                # the precision matrix the first resumed step found: ridge·I
                # (checkpoint-0.pth's was not), then the exact sum
                check(np.array_equal(records[0][3].cpu().numpy(), ridge.astype(np.float32)),
                      "the precision matrix was not reset at the start of epoch 1")
                p64 = ridge.copy()
                for feat, w, b, _ in records:
                    phi = phi64(feat, w, b)
                    p64 = p64 + phi.T @ phi
                p_card = head.precision_matrix.double().cpu().numpy()
                perr = float(np.abs(p_card - p64).max())
                saved = blob["model"]["head.precision_matrix"].double().numpy()
                print(f"  19a exact accumulation after the reset: max|diff| {perr:.3e} against "
                      f"ridge·I + the float64 sum over the 2 resumed steps (max|P| "
                      f"{np.abs(p64).max():.3e}); checkpoint-0.pth's matrix differed from "
                      f"ridge·I by {np.abs(saved - ridge).max():.3e}", flush=True)
                check(perr <= PRECISION_REL_BOUND * np.abs(p64).max(),
                      "the exact SNGP precision matrix disagrees with ridge·I + the CPU's sum")
                check(np.abs(saved - ridge).max() > 0 and records[0][0].shape == (bs_train, width),
                      "checkpoint-0.pth's precision matrix, the head's input")
                del state, head, blob
            finally:
                FT.make_finetune_train_step = make_step
            records.clear()
            print(f"  19a took {time.perf_counter() - t19:.1f} s", flush=True)

            # ---------------- 19b: --het_layer ----------------
            t19 = time.perf_counter()
            with watched_driver(torch, FT, counts) as rec:
                counted("cli8_het_train", {"K1": depth * 2, "K2": depth * 2}, FT.main,
                        train_args("het", "--het_layer", "--epochs", "1", "--steps_per_epoch", "2",
                                   "--no_save_ckpt", "--disable_eval_during_finetuning"))
                het_losses = [float(r["metrics"]["loss"]) for r in rec["steps"]]
                rec.pop("model")
            check(len(het_losses) == 2 and all(math.isfinite(x) for x in het_losses),
                  f"het losses {het_losses}")
            hargs = eval_args(d_big, "--het_layer")
            res = counted("cli8_het_evaluate", {"K1": depth * n_big // bs}, FT.main, hargs)["eval"]
            model, _ = FT.build_model(hargs, 100, dev)
            FT.load_variables(hargs, model)
            loader, _ = B.build_loaders(hargs, is_train=False)

            def het_logits(seed):
                fwd, fresh = make_eval_forward(model, het=True), per_call_generator(seed, dev)
                return collect_logits(lambda x: fwd(x, fresh()), FT._eval_batches(loader, hargs,
                                                                                  dev))

            (l0, lab), (l0b, _), (l1, _) = het_logits(0), het_logits(0), het_logits(1)
            check(np.array_equal(l0, l0b), "the het logits differ between two runs of one seed")
            check(not np.array_equal(l0, l1), "the het logits are equal under two seeds")
            check(l0.shape == (n_big, 100) and np.isfinite(l0).all() and (l0 <= 0).all(),
                  "the het log-probabilities")
            held_metrics(res, l0, lab, "--het_layer --eval")
            print(f"  19b het logits: equal between two runs of seed 0, max|diff| to seed 1 "
                  f"{np.abs(l0 - l1).max():.3e}; printed metrics equal to the CPU's from them; "
                  f"train losses {het_losses}", flush=True)
            # the rates of run_eval_dispatch over the same 1024 images, in turns
            sargs, pargs = eval_args(d_big, "--sngp"), eval_args(d_big)
            models = {"het": (hargs, model)}
            for name, a in (("sngp", sargs), ("plain", pargs)):
                m, _ = FT.build_model(a, 100, dev)
                FT.load_variables(a, m)
                models[name] = (a, m)
            walls = {k: [] for k in models}
            with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
                for name in ("plain", "het", "sngp", "sngp", "het", "plain"):
                    a, m = models[name]
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    FT.run_eval_dispatch(a, m, loader, 100)
                    torch.cuda.synchronize()
                    walls[name].append(time.perf_counter() - t)
            rates = {k: [round(n_big / w, 1) for w in v] for k, v in walls.items()}
            print(f"  19b --eval from images over {n_big} images at batch {bs} (information only;"
                  f" {card()}; run_eval_dispatch, in turns): img/s {json.dumps(rates)}", flush=True)
            del model, models, loader
            print(f"  19b took {time.perf_counter() - t19:.1f} s", flush=True)

            # ---------------- 19c: the post-hoc evaluations ----------------
            t19 = time.perf_counter()
            nb, nfit = n_test // bs, n_fit // bs
            pargs = eval_args(d_eval)
            model, _ = FT.build_model(pargs, 100, dev)
            FT.load_variables(pargs, model)
            loader, _ = B.build_loaders(pargs, is_train=False)
            logits, lab = collect_logits(make_eval_forward(model), FT._eval_batches(loader, pargs,
                                                                                    dev))
            fit_logits, fit_lab = collect_logits(make_eval_forward(model), FT._eval_batches(
                FT._fit_loader(pargs, model), pargs, dev))

            # --temp_scaling on each split
            for split, extra, n_fwd in (("eval", [], nb), ("train", [], nb + nfit),
                                        ("heldout", ["--temp_scaling_heldout_frac", "0.25"], nb)):
                res = counted(f"cli8_temp_{split}", {"K1": depth * n_fwd}, FT.main, eval_args(
                    d_eval, "--temp_scaling", "--temp_scaling_split", split, *extra))
                res = res["temp_scaling"]
                rep_l, rep_y, fl, fy = logits, lab, logits, lab
                if split == "train":
                    fl, fy = fit_logits, fit_lab
                elif split == "heldout":
                    fi, ri = CAL.heldout_split(n_test, 0.25, pargs.seed)
                    fl, fy, rep_l, rep_y = logits[fi], lab[fi], logits[ri], lab[ri]
                t_cpu = CAL.fit_temperature(fl, fy, device="cpu")
                t = res["temperature"]
                nll = [float(CAL.nll_at_temperature(torch.from_numpy(fl), torch.from_numpy(fy),
                                                    x)) for x in (t, t_cpu)]
                print(f"  --temp_scaling split {split}: T* {t} on the card, {t_cpu} by the CPU's "
                      f"fit on the card's logits; the CPU's NLL at them {nll[0]:.7f} / "
                      f"{nll[1]:.7f} (bound {TEMP_NLL_RTOL} relative)", flush=True)
                check(0.05 < t < 20 and nll[0] - nll[1] <= TEMP_NLL_RTOL * nll[1],
                      f"T* {t} does not minimize the CPU's NLL as its own fit {t_cpu} does")
                held_metrics(res, rep_l / t, rep_y, f"--temp_scaling {split}",
                             extra=("temperature", "heldout_fit_samples"))

            # --laplace, probit and mc, fitted on the 1024 train images
            ffwd = LA.make_feature_forward(model)
            fit_batches = list(FT._eval_batches(FT._fit_loader(pargs, model), pargs, dev))
            torch.cuda.synchronize()
            t = time.perf_counter()
            fit_out = [ffwd(x) for x, _ in fit_batches]
            head_params = {"weight": model.head.weight.detach(), "bias": model.head.bias.detach()}
            la = LA.fit_last_layer_laplace(lambda i: fit_out[i], head_params,
                                           [(i, y) for i, (_, y) in enumerate(fit_batches)])
            fit_ms = (time.perf_counter() - t) * 1000
            a_sum = sum(LA._augment(f).t() @ LA._augment(f) for _, f in fit_out)
            eigh_ms = cuda_ms(lambda: torch.linalg.eigh(a_sum), 5)
            la = LA.optimize_prior_precision(la)
            feats_fit = torch.cat([f for _, f in fit_out]).float().cpu().numpy()
            logits_fit = torch.cat([lg for lg, _ in fit_out]).float().cpu().numpy()
            eval_batches = list(FT._eval_batches(loader, pargs, dev))
            eval_out = [ffwd(x) for x, _ in eval_batches]
            feats = torch.cat([f for _, f in eval_out]).float().cpu().numpy()
            elog = torch.cat([lg for lg, _ in eval_out]).float().cpu().numpy()
            print(f"  --laplace fit on the card (information only; {card()}): features and "
                  f"factor sums over {n_fit} images {fit_ms:.2f} ms (host clock, synchronized), "
                  f"eigh of A [{width + 1}, {width + 1}] {eigh_ms:.3f} ms (CUDA events); prior precision "
                  f"{la.prior_precision:g}", flush=True)
            phi = np.concatenate([feats_fit.astype(np.float64), np.ones((n_fit, 1))], axis=1)
            p = torch.softmax(torch.from_numpy(logits_fit).double(), -1).numpy()
            factors = (la.q_a.cpu(), la.a.cpu(), la.q_g.cpu(), la.g.cpu(), la.n)
            for what, exact, q, lam in (("A", phi.T @ phi, la.q_a, la.a),
                                        ("G", np.diag(p.sum(0)) - p.T @ p, la.q_g, la.g)):
                q, lam = q.double().cpu().numpy(), lam.double().cpu().numpy()
                ferr = float(np.abs(q @ np.diag(lam) @ q.T - exact).max())
                print(f"  --laplace factor {what} {exact.shape}: Q diag(λ) Qᵀ from the card vs the "
                      f"float64 sum from its features: max|diff| {ferr:.3e}, max|{what}| "
                      f"{np.abs(exact).max():.3e} (bound {LAPLACE_FACTOR_RTOL} of it)", flush=True)
                check(ferr <= LAPLACE_FACTOR_RTOL * np.abs(exact).max(),
                      f"the Laplace factor {what} disagrees with the float64 sum")
            for link in ("probit", "mc"):
                res = counted(f"cli8_laplace_{link}", {"K1": depth * (nfit + nb)}, FT.main,
                              eval_args(d_eval, "--laplace", "--laplace_link", link))["laplace"]
                check(res["prior_precision"] == la.prior_precision, "the driver's prior precision")
                fresh = per_call_generator(pargs.seed, dev)
                preds, ref, draw_max = [], [], 0.0
                for lg, f in eval_out:
                    eps = LA.draw_mc_eps(fresh(), 32, *lg.shape) if link == "mc" else None
                    preds.append(LA.predictive_log_probs(la, lg, f, link, eps=eps).cpu().numpy())
                    if link == "mc":
                        s = LA.functional_variance(la, f)
                        draws = lg.float()[None] + (s.sqrt()[None] * eps) @ la.q_g.t()
                        draw_max = max(draw_max, float(draws.abs().max()))
                    ref.append(laplace_f64(
                        np, None, None, f.float().cpu().numpy(), lg.float().cpu().numpy(),
                        la.prior_precision, link, factors=factors,
                        eps=None if eps is None else eps.cpu().numpy()))
                pred, ref = np.concatenate(preds), np.concatenate(ref)
                perr = float(np.abs(pred - ref).max())
                refit = ""
                if link == "probit":
                    refit = float(np.abs(pred - laplace_f64(
                        np, feats_fit, logits_fit, feats, elog, la.prior_precision, "probit")).max())
                    refit = f"; against a whole float64 refit (information) {refit:.3e}"
                bound = LAPLACE_ATOL + LAPLACE_MC_DRAW_RTOL * draw_max
                print(f"  --laplace {link}: the card's predictive log-probs vs a float64 CPU "
                      f"recomputation on its factors from its features: max|diff| {perr:.3e} "
                      f"(bound {bound:.3e}" + (f"; largest draw {draw_max:.1f}" if draw_max else "")
                      + f"){refit}", flush=True)
                check(perr <= bound, f"the {link} Laplace predictive disagrees")
                if link == "probit":
                    held_metrics(res, pred, lab, f"--laplace {link}", extra=("prior_precision",))
                    continue
                # the mc link's probabilities are sums of nearly one-hot
                # softmaxes, k/32 apart: many ties, which the card's and the
                # CPU's softmax round apart differently. The metrics that
                # take the argmax of the probabilities (ECE, MCE, OE) or rank
                # them (AUROC, the adaptive TACE / ACE) move with them; so
                # every metric is recomputed on the CPU from the card's
                # softmax probabilities, and every other metric also from
                # the CPU's own softmax
                tie_ranked = ("ece", "mce", "oe", "auroc", "tace", "ace")
                on_cpu = held_metrics(res, pred, lab, f"--laplace {link}",
                                      extra=("prior_precision",), skip=tie_ranked)
                card_p = M.softmax_probs(torch.from_numpy(pred).to(dev)).cpu()
                held_metrics(res, pred, lab, f"--laplace {link} (the card's probabilities)",
                             extra=("prior_precision",), probs=card_p)
                tied = float(np.mean([len(np.unique(r)) for r in np.round(
                    np.exp(pred) * 32, 3)]))
                print(f"  --laplace mc: printed metrics equal to the CPU's recomputation from the "
                      f"card's softmax probabilities, and, but for {', '.join(tie_ranked)}, from "
                      f"the CPU's own; from the CPU's own: " + ", ".join(
                          f"{k} {on_cpu[k]:.6f} / {res[k]:.6f}" for k in tie_ranked)
                      + f" (CPU / printed); distinct values of 32·p a row {tied:.1f} of 100",
                      flush=True)

            # --corrupted_data: plain, --mc_dropout, --laplace
            mc_flags = ["--mc_dropout", "--drop", "0.1"]
            c_fwd = -(-n_c // bs) * len(distortions)
            for mode, extra, expect in (
                    ("", [], {"K1": depth * c_fwd}),
                    ("_mc", mc_flags, {"K1": depth * c_fwd, "K8": 2 * depth * c_fwd}),
                    ("_laplace", ["--laplace"], {"K1": depth * (c_fwd + nfit)})):
                cargs = eval_args(d_eval, "--corrupted_data", "--corruption_data_path", croot,
                                  *extra)
                timed = []
                harness = R.evaluate_corruption

                def timed_harness(*a, **k):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = harness(*a, **k)
                    torch.cuda.synchronize()
                    timed.append(time.perf_counter() - t)
                    return out

                R.evaluate_corruption = timed_harness
                try:
                    res = counted(f"cli8_corrupted{mode}", expect, FT.main, cargs)["corruption"]
                finally:
                    R.evaluate_corruption = harness
                c_s = timed[0]
                cmodel, _ = FT.build_model(cargs, 100, dev)
                FT.load_variables(cargs, cmodel)
                if mode == "_mc":
                    fwd = FT._mc_mean_forward(cargs, cmodel)
                elif mode == "_laplace":
                    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
                        _, lffwd, lpred = FT._fit_laplace(cargs, cmodel)
                    fwd = lambda x: lpred(*lffwd(x))  # noqa: E731
                else:
                    fwd = make_eval_forward(cmodel)
                for name in distortions:
                    ds = D.load_cifar_c(croot, name, 1)
                    batches = [(eval_transform_batch(torch.from_numpy(ds.images[i:i + bs]).to(dev),
                                                     224, 224 / 256), ds.labels[i:i + bs])
                               for i in range(0, len(ds), bs)]
                    lg, y = collect_logits(fwd, batches)
                    acc = float(100.0 * np.mean(lg.argmax(1) == y))
                    got = res["per_distortion"][name]["acc1"]
                    check(abs(got - acc) <= 1e-3 and len(y) == n_c,
                          f"-C{mode} {name}: printed acc1 {got}, from the card's logits {acc}")
                accs = [res["per_distortion"][d]["acc1"] for d in distortions]
                check(abs(res["mean_acc"] - np.mean(accs)) <= 1e-9
                      and abs(res["mce_unnormalized"] - np.mean([(100 - a) / 100 for a in accs]))
                      <= 1e-9, f"-C{mode} summary")
                print(f"  --corrupted_data{mode.replace('_', ' --')}: acc1 {accs} equal to the "
                      f"CPU's from the card's logits; {len(distortions) * n_c} images through "
                      f"evaluate_corruption in {c_s * 1000:.1f} ms = "
                      f"{len(distortions) * n_c / c_s:.1f} img/s (information only; {card()}"
                      f"{'; after the Laplace fit' if mode == '_laplace' else ''})", flush=True)
                del cmodel

            # --perturbed_data: plain and --mc_dropout, the harness's list cut
            # to the two perturbations written here
            R.PERTURBATIONS = perturbations
            p_fwd = len(perturbations) * -(-n_vid // (bs // n_frames))
            for mode, extra, expect in (("", [], {"K1": depth * p_fwd}),
                                        ("_mc", mc_flags, {"K1": depth * p_fwd,
                                                           "K8": 2 * depth * p_fwd})):
                pa = eval_args(d_eval, "--perturbed_data", "--perturbation_data_path", proot,
                               *extra)
                res = counted(f"cli8_perturbed{mode}", expect, FT.main, pa)["perturbation"]
                pmodel, _ = FT.build_model(pa, 100, dev)
                FT.load_variables(pa, pmodel)
                fwd = FT._mc_mean_forward(pa, pmodel) if mode else make_eval_forward(pmodel)
                for name in perturbations:
                    vids = D.load_cifar_p(proot, name)
                    frames = torch.from_numpy(vids.reshape(-1, 32, 32, 3)).to(dev)
                    lg = np.concatenate([fwd(R.process_p_frames(frames[i:i + bs], 224)).float()
                                         .cpu().numpy() for i in range(0, len(frames), bs)])
                    lg = lg.reshape(n_vid, n_frames, 100)
                    noise = "noise" in name
                    ranks = [np.stack([R._rankdata_ordinal_desc(f) for f in v]) for v in lg]
                    ref = {"flip_prob": R.flip_prob([v.argmax(1) for v in lg], noise),
                           "zipf": R.ranking_dist(ranks, noise, "zipf", 100),
                           "top5": R.ranking_dist(ranks, noise, "top5", 100)}
                    got = res["per_perturbation"][name]
                    check(got == ref, f"-P{mode} {name}: printed {got}, from the card's logits "
                                      f"{ref}")
                print(f"  --perturbed_data{mode.replace('_', ' --')}: {json.dumps(res)} equal to "
                      f"the CPU's from the card's logits", flush=True)
                del pmodel
            R.PERTURBATIONS = perturbation_list

            # --visualize_embedding over the 256 test images
            ea = eval_args(d_eval, "--visualize_embedding")
            out = counted("cli8_embedding", {"K1": depth * nb}, FT.main, ea)
            tsv = np.loadtxt(os.path.join(out, "embeddings.tsv"))
            tsv_lab = np.loadtxt(os.path.join(out, "embeddings_labels.tsv"))
            with torch.inference_mode():
                model.eval()
                ref = np.concatenate([model.forward_features(x).float().cpu().numpy()
                                      for x, _ in eval_batches])
            eerr = float(np.abs(tsv - ref).max())
            print(f"  --visualize_embedding: {tsv.shape} features, max|tsv - the card's pooled "
                  f"features| {eerr:.2e} (written at 6 decimals); png written: "
                  f"{os.path.exists(os.path.join(out, 'embeddings_pca.png'))}", flush=True)
            check(tsv.shape == (n_test, width) and eerr <= 1e-6
                  and np.array_equal(tsv_lab, lab), "the embedding TSVs")
            del model, loader, la, fit_out, eval_out, fit_batches, eval_batches
            print(f"  19c took {time.perf_counter() - t19:.1f} s", flush=True)
    finally:
        FA.BOUNDED_SCORES, R.PERTURBATIONS = bounded, perturbation_list
    return paths



# Phase 20: the cyclical teacher after a step against the EMA rule applied to
# copies of the teacher and the updated student in float64: the card's f32
# update rounds each product and the sum once (~6e-8 relative).
EMA_REL_BOUND = 1e-6


def phase20(torch, FA, dev, step_rates):
    """The cyclical (data2vec) pretraining driver on the card:
    cli.pretrain_cyclical.main at the recipe's flags over seeded 32x32
    CIFAR-100 images (20a: two epochs, a step on the plain attention, a
    resumed third epoch; 20b: --gp_layer; 20c: the last checkpoint through
    cli.finetune --eval). step_rates: phase 4's step-only img/s, for the
    rate beside. Returns the launches of each path."""
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from uncertainty_vit_tpu_torch.cli import builders as B
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.cli import pretrain_cyclical as PC
    from uncertainty_vit_tpu_torch.ops import augment as A
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import masking as M
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.train import engine_cyclical as EC
    from uncertainty_vit_tpu_torch.train.ema import cyclical_ema_decay, cyclical_ema_step
    from uncertainty_vit_tpu_torch.utils import checkpoint as C

    n_train, n_test, bs, depth, spe = 1024, 256, 128, 12, 4
    rs = np.random.RandomState(20)
    train_images = rs.randint(0, 256, (n_train, 32, 32, 3), dtype=np.uint8)
    test_images = rs.randint(0, 256, (n_test, 32, 32, 3), dtype=np.uint8)

    def counts():
        # inside attention_on_plain the attention wrappers are plain
        # functions, which count nothing
        return kernel_counts(FA, TQ, DO) if hasattr(FA.fused_qkv_attention_bwd, "launches") else {}

    want = {k: 0 for k in counts()}
    per_step = dict(want, K1=2 * depth, K2=depth)
    paths = {}
    # what the driver does, seen through its own entry points: each call of
    # its train step (host clock, launches, masks, the softmax mode; around
    # step 0 the teacher and the student), each epoch's log record (host
    # clock), the state auto_load restored, lm_head's inputs under --gp_layer
    steps, writes, resumed, lm_inputs = [], [], [], []
    watch = {"sync_check": None, "ema_check": False, "gp": False, "prof_start": None,
             "prof_stop": None}
    make_step, auto_load, jsonl = PC.make_cyclical_train_step, PC.C.auto_load, PC.JsonlLogger
    import_sd = C.import_torch_state_dict

    def recording_make_step(model, *a, **k):
        step = make_step(model, *a, **k)
        if watch["gp"]:
            def record(mod, args, kwargs):
                if kwargs.get("update_cov"):
                    ln = mod._gp_input_normalize_layer
                    lm_inputs.append((args[0].detach().float().clone(), ln.weight.detach().clone(),
                                      ln.bias.detach().clone()))

            model.lm_head.register_forward_pre_hook(record, with_kwargs=True)

        def recorded(state, images, masks, *rest):
            if state.step in (watch["prof_start"], watch["prof_stop"]):
                torch.cuda.synchronize()
                if state.step == watch["prof_start"]:
                    watch["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                        ProfilerActivity.CUDA])
                    watch["prof"].start()
                    watch["prof_t"] = time.perf_counter()
                else:
                    watch["prof_ms"] = (time.perf_counter() - watch["prof_t"]) * 1000
                    watch["prof"].stop()
            r = {"step": state.step, "bounded": FA.BOUNDED_SCORES, "masks": masks.clone()}
            if watch["ema_check"] and state.step < 2:
                r["teacher_before"] = {k: v.detach().clone() for k, v in state.model_ema.items()}
            before = counts()
            checked = state.step == watch["sync_check"]
            r["t"] = time.perf_counter()
            if checked:
                torch.cuda.set_sync_debug_mode("error")
            try:
                m = step(state, images, masks, *rest)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            r["sync_checked"] = checked
            after = counts()
            r.update(metrics=m, launches={k: after[k] - before[k] for k in after})
            if "teacher_before" in r:
                r["student"] = {k: p.detach().clone() for k, p in model.named_parameters()}
                r["teacher"] = {k: v.detach().clone() for k, v in state.model_ema.items()}
            steps.append(r)
            return m

        return recorded

    class TimedJsonl(jsonl):
        def write(self, record):
            writes.append(time.perf_counter())
            super().write(record)

    def recording_auto_load(output_dir, state):
        state, epoch = auto_load(output_dir, state)
        resumed.append({"epoch": epoch, "step": state.step,
                        "model": {k: v.detach().clone()
                                  for k, v in state.model.state_dict().items()},
                        "teacher": {k: v.detach().clone() for k, v in state.model_ema.items()},
                        "optimizer": {i: {k: v.clone() for k, v in st.items()} for i, st in
                                      state.optimizer.state_dict()["state"].items()}})
        return state, epoch

    def counted(path, expect, fn, *a, **k):
        reset_kernel_counts(FA, TQ, DO)
        out = fn(*a, **k)
        torch.cuda.synchronize()
        paths[path] = counts()
        exp = dict(want, **expect)
        print(f"  {path}: launches {paths[path]}", flush=True)
        check(paths[path] == exp, f"{path} launched {paths[path]}, expected {exp}")
        return out

    def finite(records, what):
        for r in records:
            for k in ("loss", "loss_cyc", "grad_norm"):
                check(math.isfinite(float(r["metrics"][k])),
                      f"{what}: step {r['step']} {k} {float(r['metrics'][k])}")

    bounded = FA.BOUNDED_SCORES
    PC.make_cyclical_train_step, PC.C.auto_load, PC.JsonlLogger = (
        recording_make_step, recording_auto_load, TimedJsonl)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_cifar100(tmp, train_images, np.arange(n_train) % 100, "train")
            write_cifar100(tmp, test_images, np.arange(n_test) % 100, "test")
            out = os.path.join(tmp, "out")

            def args_of(out_dir, *extra):
                # the recipe (BASELINE.md:34) at its per-GPU batch
                return PC.get_args_parser().parse_args([
                    "--model", "beit_base_patch16_224", "--input_size", "224",
                    "--data_set", "CIFAR100", "--data_path", tmp, "--batch_size", str(bs),
                    "--num_workers", "8", "--output_dir", out_dir, "--steps_per_epoch", str(spe),
                    "--save_ckpt_freq", "2", "--lr", "2e-3", "--warmup_epochs", "1",
                    "--num_mask_patches", "120", "--ema_decay", "0.9998",
                    "--ema_decay_init", "0.999", "--clip_grad", "3.0", "--drop_path", "0.25",
                    "--attn_drop_rate", "0.05", "--target_layers", "[6,7,8,9,10,11]",
                    "--layer_scale_init_value", "0.1", *extra])

            # ---------------- 20a: two epochs of 4 steps ----------------
            t20 = time.perf_counter()
            args = args_of(out, "--epochs", "2")
            watch.update(sync_check=spe + 1, ema_check=True)
            FA.BOUNDED_SCORES = True  # as phase 4 and the finetune driver left it
            t0 = time.perf_counter()
            state = counted("cli9_train", {"K1": 2 * depth * 2 * spe, "K2": depth * 2 * spe},
                            PC.main, args)
            main_s = time.perf_counter() - t0
            watch.update(sync_check=None, ema_check=False)
            run1, writes1 = list(steps), list(writes)
            check(len(run1) == 2 * spe and state.step == 2 * spe,
                  f"{len(run1)} step calls, state step {state.step}")
            for r in run1:
                check(r["launches"] == per_step, f"step {r['step']} launched {r['launches']}")
                check(r["bounded"] is False, f"step {r['step']} ran the bounded softmax")
            check(not FA.BOUNDED_SCORES, "the driver left BOUNDED_SCORES on")
            finite(run1, "train")
            check(any(r["sync_checked"] for r in run1),
                  "the step under sync debug mode did not run")
            # the masks each step received: the host op's on the draws of the
            # step's CPU generator
            host_ms = []
            for r in run1:
                t = time.perf_counter()
                host = M.make_blockwise_masks(EC.mask_generator(args.seed, r["step"]), bs,
                                              (14, 14), 120, 16)
                host_ms.append((time.perf_counter() - t) * 1000)
                check(torch.equal(r["masks"], torch.from_numpy(host).to(dev)),
                      f"step {r['step']}'s masks are not the host op's")
            counts_m = [float(r["metrics"]["mask_count"]) for r in run1]
            check(all(0 < c <= 120 for c in counts_m), f"mask counts {counts_m}")
            with open(os.path.join(out, "log.txt")) as f:
                log = [json.loads(line) for line in f]
            keys = {"epoch"} | {f"train_{k}" for k in ("loss", "loss_cyc", "loss_var0",
                                                         "grad_norm", "mask_count", "lr")}
            check([r["epoch"] for r in log] == [0, 1] and all(set(r) == keys for r in log),
                  f"log.txt: {log}")
            check(os.path.isfile(os.path.join(out, "checkpoint-1.pth")),
                  "checkpoint-1.pth was not written")
            print("  losses " + ", ".join(f"{float(r['metrics']['loss']):.5f}" for r in run1)
                  + "; grad norms " + ", ".join(f"{float(r['metrics']['grad_norm']):.4f}"
                                               for r in run1)
                  + f"; mask counts {counts_m}; every step K1 {2 * depth} (teacher and student), "
                  f"K2 {depth}, the exact softmax though BOUNDED_SCORES was on before main()",
                  flush=True)
            print(f"  step {spe + 1} ran with torch.cuda.set_sync_debug_mode('error'): no host "
                  f"synchronization inside the driver's step; the masks of all {len(run1)} steps "
                  f"equal the host op's from the step's CPU generator", flush=True)

            # the teacher after steps 0 and 1 (the warm-up's lr is 0 at step 0,
            # so the student moves from step 1 on): the EMA rule on copies, in
            # float64
            for r in run1[:2]:
                d = cyclical_ema_decay(r["step"], args.ema_decay, args.ema_decay_init,
                                       args.ema_start_at)
                worst, moved = 0.0, 0.0
                for k, e0 in r["teacher_before"].items():
                    exp = e0.double() * d + r["student"][k].double() * (1.0 - d)
                    err = float((r["teacher"][k].double() - exp).abs().max())
                    worst = max(worst, err / max(float(exp.abs().max()), 1e-30))
                    moved = max(moved, float((r["teacher"][k] - e0).abs().max()))
                print(f"  teacher after step {r['step']} against d·e + (1 - d)·m on copies in "
                      f"float64 (d = {d!r}): worst tensor's max|diff| / max|expected| "
                      f"{worst:.3e} (bound {EMA_REL_BOUND}); it moved by up to {moved:.3e}",
                      flush=True)
                check(worst <= EMA_REL_BOUND,
                      f"the teacher after step {r['step']} is not the EMA rule's")
            check(moved > 0, "the teacher did not move at step 1")
            for r in run1:
                for k in ("teacher_before", "student", "teacher"):
                    r.pop(k, None)
            rates = [spe * bs / (writes1[e] - run1[e * spe]["t"]) for e in range(2)]
            print(f"  driver pretrain rate from images (information only; host clock from an "
                  f"epoch's first step call to its log record, the readback of its last step "
                  f"included): {rates} img/s (epoch 0 includes the first call's warm-up); "
                  f"phase 4's finetune step-only rate in this call: kernel "
                  f"{step_rates['kernel']} img/s; main() with model build and checkpoint "
                  f"{main_s:.2f} s", flush=True)

            # --- step 0 on the plain attention: same flags, state, batch, masks
            # and per-step generators
            steps.clear()
            reset_kernel_counts(FA, TQ, DO)
            with attention_on_plain(torch, FA):
                PC.main(args_of(os.path.join(tmp, "plain"), "--epochs", "1", "--steps_per_epoch",
                                "1", "--no_save_ckpt", "--no_auto_resume"))
            torch.cuda.synchronize()
            check(kernel_counts(FA, TQ, DO) == want, "the plain-attention run launched a kernel")
            m_k, m_p = run1[0]["metrics"], steps[0]["metrics"]
            loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
            gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
            print(f"  driver's step 0, kernels vs plain attention: loss {loss_k:.6f} / "
                  f"{loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
            check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
                  "the driver's first loss disagrees with the plain attention's")
            check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
                  "the driver's first grad norm disagrees with the plain attention's")
            check(torch.equal(steps[0]["masks"], run1[0]["masks"]), "the plain run's masks")

            # --- the pretrain transform on the card against the CPU's, on the
            # driver's first batch with the draws of its step 0
            loader, _ = B.build_loaders(args, is_train=True, letterbox_ok=True)
            loader.set_epoch(0)
            first = next(iter(loader))[0]
            draws = A.draw_pretrain_augment(EC.step_generators(args.seed, 0, dev).augment, bs)
            u8 = torch.from_numpy(first).to(dev)
            on_card = A.pretrain_augment_batch(draws, u8, 224).cpu()
            cpu_draws = draws.to("cpu")
            on_cpu = A.pretrain_augment_batch(cpu_draws, torch.from_numpy(first), 224)

            def crop(d_, x):
                jit = A.color_jitter_batch(d_.color_jitter, A.to_planar(x))
                return A.random_resized_crop_batch(d_.rrc, A.random_hflip_batch(d_.flip_u, jit),
                                                   224)

            crop_diff = (crop(draws, u8).cpu() - crop(cpu_draws, torch.from_numpy(first))
                         ).abs().max().item()
            diff = (on_card - on_cpu).abs()
            near = (diff > AUG_NEAR_ATOL).float().mean().item()
            flips = (diff > AUG_FLIP_ATOL).float().mean().item()
            print(f"  pretrain transform {tuple(first.shape)} -> {tuple(on_card.shape)}, card vs "
                  f"CPU on the same draws: jitter, flip and crop max|diff| {crop_diff:.3e} "
                  f"(bound {AUG_CROP_ATOL}); whole transform max|diff| {diff.max().item():.3e}, "
                  f"share beyond {AUG_NEAR_ATOL} {near:.2e} (bound {AUG_NEAR_SHARE}), beyond "
                  f"{AUG_FLIP_ATOL:.4f} {flips:.2e} (bound {AUG_FLIP_SHARE})", flush=True)
            check(tuple(on_card.shape) == (bs, 224, 224, 3) and bool(torch.isfinite(on_card).all()),
                  "the pretrain transform's output")
            check(crop_diff <= AUG_CROP_ATOL, "the crop on the card disagrees with the CPU's")
            check(near <= AUG_NEAR_SHARE and flips <= AUG_FLIP_SHARE,
                  "the pretrain transform on the card disagrees with the CPU's")
            del on_card, on_cpu, draws, cpu_draws

            # --- --epochs 3 on the same directory: auto-resumes at epoch 2 from
            # checkpoint-1.pth; steps 9 and 10 profiled
            steps.clear()
            args3 = args_of(out, "--epochs", "3")
            watch.update(prof_start=2 * spe + 1, prof_stop=2 * spe + 3)
            state = counted("cli9_train_resume", {"K1": 2 * depth * spe, "K2": depth * spe},
                            PC.main, args3)
            watch.update(prof_start=None, prof_stop=None)
            check(len(resumed) == 2 and resumed[0]["epoch"] == 0 and resumed[1]["epoch"] == 2
                  and resumed[1]["step"] == 2 * spe,
                  f"auto-resume: {[(r['epoch'], r['step']) for r in resumed]}")
            blob = torch.load(os.path.join(out, "checkpoint-1.pth"), map_location=dev,
                              weights_only=False)
            got = resumed[1]
            check(blob["step"] == 2 * spe and blob["epoch"] == 1, "checkpoint-1.pth's step, epoch")
            check(got["model"].keys() == blob["model"].keys()
                  and all(torch.equal(got["model"][k], v) for k, v in blob["model"].items()),
                  "the resumed student is not checkpoint-1.pth's")
            check(got["teacher"].keys() == blob["model_ema"].keys()
                  and all(torch.equal(got["teacher"][k], v) for k, v in blob["model_ema"].items()),
                  "the resumed teacher is not checkpoint-1.pth's")
            saved = blob["optimizer"]["state"]
            check(got["optimizer"].keys() == saved.keys()
                  and all(torch.equal(got["optimizer"][i][k], v.to(got["optimizer"][i][k].device))
                          for i, st in saved.items() for k, v in st.items()),
                  "the resumed AdamW moments are not checkpoint-1.pth's")
            lr3, _, _ = B.build_lr_schedules(args3, spe)
            check(steps[0]["step"] == 2 * spe and steps[0]["metrics"]["lr"] == lr3(2 * spe),
                  f"the resumed run's first step {steps[0]['step']} lr {steps[0]['metrics']['lr']}")
            finite(steps, "resumed")
            for r in steps:
                check(r["launches"] == per_step, f"resumed step {r['step']} launched "
                                                 f"{r['launches']}")
            n_opt = sum(len(st) for st in saved.values())
            print(f"  --epochs 3 resumed at epoch {got['epoch']}, step {got['step']}: "
                  f"{len(got['model'])} student, {len(got['teacher'])} teacher and {n_opt} AdamW "
                  f"tensors equal to checkpoint-1.pth's; first lr {steps[0]['metrics']['lr']:.6e}"
                  f" = the schedule's at update {2 * spe}", flush=True)
            del blob, got
            resumed.clear()
            busy_ms, idle, top = trace_summary(watch.pop("prof"))
            print(f"  profiled driver steps {2 * spe + 1} and {2 * spe + 2} (the card synchronized "
                  f"at both ends, the loader, masks, copies, readback and host between): wall "
                  f"{watch['prof_ms']:.2f} ms, CUDA kernel and copy time {busy_ms:.2f} ms, busy "
                  f"share {busy_ms / watch['prof_ms']:.3f}; the card idle (ms) "
                  f"{json.dumps({k: round(v, 2) for k, v in idle.items()})} before its first "
                  f"kernel, between, after its last; top kernels (ms): {json.dumps(top)}",
                  flush=True)

            # --- where a step's time goes, by part (CUDA events; the host op's
            # masks by the host clock), on the resumed run's state and batch
            model, teacher, opt = state.model, state.teacher, state.optimizer
            hp = PC.hparams(args3, spe)
            gens = EC.step_generators(args.seed, 99, dev)
            aug_fn = A.make_pretrain_augment(224)
            images = aug_fn(gens.augment, u8)
            masks = torch.from_numpy(M.make_blockwise_masks(EC.mask_generator(0, 99), bs)).to(dev)

            def teacher_targets():
                with torch.no_grad():
                    return EC.build_targets(teacher(images, None, deterministic=True,
                                                    layer_results="end"), hp)

            targets = teacher_targets()

            def student_fwd_bwd():
                model.train()
                out_ = model(images, masks, generator=gens.model).float()
                loss = ((out_ - targets) ** 2 * masks[..., None]).mean()
                opt.zero_grad()
                loss.backward()

            student_fwd_bwd()
            ema_t = {k: v.detach().clone() for k, v in state.model_ema.items()}
            params = dict(model.named_parameters())
            parts = {
                "transform": cuda_ms(lambda: aug_fn(gens.augment, u8), 10),
                "teacher_forward_targets": cuda_ms(teacher_targets, 10),
                "student_forward_backward": cuda_ms(student_fwd_bwd, 10),
                "adamw_clip": cuda_ms(lambda: opt.step(1e-3, 0.05), 10),
                "ema": cuda_ms(lambda: cyclical_ema_step(ema_t, params, 0, 0.9998, 0.999, 0), 10),
            }
            # the clipped AdamW's many small launches outpace nothing when
            # called alone: its kernels' own time, from a trace
            parts["adamw_clip_kernels"] = sum(
                kernel_split(torch, lambda: opt.step(1e-3, 0.05), 5).values())
            t = time.perf_counter()
            for i in range(10):
                M.make_blockwise_masks(EC.mask_generator(0, i), bs)
            parts["masks_host"] = (time.perf_counter() - t) * 100
            step_ms = bs * 1000 / rates[1]
            print(f"  a step's parts at batch {bs}, ms (CUDA events; masks_host by the host "
                  f"clock, made a batch ahead on the host): "
                  f"{json.dumps({k: round(v, 3) for k, v in parts.items()})}; their device sum "
                  f"{sum(v for k, v in parts.items() if k not in ('masks_host', 'adamw_clip')):.2f}"
                  f" ms (AdamW by its kernels) against the "
                  f"driver's {step_ms:.2f} ms a step (epoch 1); the masks of the {len(host_ms)} "
                  f"steps on the host {[round(v, 2) for v in host_ms]} ms", flush=True)
            del state, model, teacher, opt, ema_t, params, images, targets
            print(f"  20a took {time.perf_counter() - t20:.1f} s", flush=True)

            # ---------------- 20b: --gp_layer, 2 steps ----------------
            t20 = time.perf_counter()
            steps.clear()
            watch["gp"] = True
            state = counted("cli9_gp_train", {"K1": 2 * depth * 2, "K2": depth * 2}, PC.main,
                            args_of(os.path.join(tmp, "gp"), "--gp_layer", "--epochs", "1",
                                    "--steps_per_epoch", "2", "--no_save_ckpt",
                                    "--no_auto_resume"))
            watch["gp"] = False
            finite(steps, "--gp_layer")
            head = state.model.lm_head
            width = state.model.cfg.embed_dim
            check(len(lm_inputs) == 2 and lm_inputs[0][0].shape == (bs * 196, width),
                  f"{len(lm_inputs)} lm_head updates")
            ridge = 1e-3 * np.eye(width)
            wrf = head._random_feature.weight.double().cpu().numpy()
            brf = head._random_feature.bias.double().cpu().numpy()
            p64 = ridge.copy()
            for feat, w, b in lm_inputs:
                x = feat.double().cpu().numpy()
                x = (x - x.mean(1, keepdims=True)) / np.sqrt(x.var(1, keepdims=True) + 1e-12)
                x = x * w.double().cpu().numpy() + b.double().cpu().numpy()
                phi = np.cos(x @ wrf.T + brf)
                p64 = 0.999 * p64 + 0.001 * (phi.T @ phi) / len(phi)
            perr = float(np.abs(head.precision_matrix.double().cpu().numpy() - p64).max())
            losses = [round(float(r["metrics"]["loss"]), 5) for r in steps]
            print(f"  20b --gp_layer: losses {losses}"
                  f"; the precision matrix after 2 steps vs a float64 CPU recomputation from "
                  f"lm_head's [B·N, C] = {tuple(lm_inputs[0][0].shape)} inputs: max|diff| "
                  f"{perr:.3e}, max|P| {np.abs(p64).max():.3e} (bound {PRECISION_REL_BOUND} of it)",
                  flush=True)
            check(perr <= PRECISION_REL_BOUND * np.abs(p64).max(),
                  "the SNGP lm_head's precision matrix disagrees with the CPU's recomputation")
            for r in steps:
                check(r["launches"] == per_step, f"--gp_layer step launched {r['launches']}")
            lm_inputs.clear()
            del state, head
            print(f"  20b took {time.perf_counter() - t20:.1f} s", flush=True)

            # ---------------- 20d: one --quant int8 step ----------------
            # the teacher's forward quantizes too (JAX models/layers.py:51-63):
            # K6 48 for it, 48 for the student's forward and 48 for its dgrad
            t20 = time.perf_counter()
            steps.clear()
            counted("cli9_int8_train", {"K1": 2 * depth, "K2": depth, "K6": 12 * depth,
                                        "K7": 4 * depth}, PC.main,
                    args_of(os.path.join(tmp, "int8"), "--quant", "int8", "--epochs", "1",
                            "--steps_per_epoch", "1", "--no_save_ckpt", "--no_auto_resume"))
            finite(steps, "--quant int8")
            print(f"  20d --quant int8 step: loss {float(steps[0]['metrics']['loss']):.5f}, grad "
                  f"norm {float(steps[0]['metrics']['grad_norm']):.4f}; took "
                  f"{time.perf_counter() - t20:.1f} s", flush=True)

            # ---------------- 20c: the hand-off to the finetune driver ----------
            t20 = time.perf_counter()
            imports = []

            def recording_import(sd, template, *a, **k):
                result = import_sd(sd, template, *a, **k)
                imports.append({"sd": sd, "template": {k_: v.detach().cpu()
                                                       for k_, v in template.items()},
                                "result": result})
                return result

            pth = os.path.join(out, "checkpoint-2.pth")
            C.import_torch_state_dict = recording_import
            try:
                res = counted("cli9_finetune_eval", {"K1": depth * 2}, FT.main,
                              FT.get_args_parser().parse_args([
                                  "--model", "beit_base_patch16_224", "--input_size", "224",
                                  "--data_set", "CIFAR100", "--data_path", tmp, "--num_workers",
                                  "8", "--batch_size", str(bs), "--finetune", pth, "--eval",
                                  "--output_dir", os.path.join(tmp, "ft")]))
            finally:
                C.import_torch_state_dict = import_sd
            check(len(imports) == 1, f"{len(imports)} imports")
            _, missing, unused = imports[0]["result"]
            _, cpu_missing, cpu_unused = import_sd(C.load_torch_state_dict(pth),
                                                   imports[0]["template"])
            print(f"  20c checkpoint-2.pth through cli.finetune --finetune --eval over {n_test} "
                  f"images: missing {missing}, unused {unused}; acc1 "
                  f"{res['eval']['acc1']:.3f}", flush=True)
            check(missing == cpu_missing and unused == cpu_unused,
                  f"the card's import gave missing {missing}, unused {unused}; the CPU's "
                  f"{cpu_missing}, {cpu_unused}")
            check(sorted(missing) == ["fc_norm.bias", "fc_norm.weight", "head.bias", "head.weight"]
                  and sorted(unused) == ["lm_head.bias", "lm_head.weight", "mask_token",
                                         "norm.bias", "norm.weight"], "the hand-off's keys")
            print(f"  20c took {time.perf_counter() - t20:.1f} s", flush=True)
    finally:
        PC.make_cyclical_train_step, PC.C.auto_load, PC.JsonlLogger = make_step, auto_load, jsonl
        C.import_torch_state_dict = import_sd
        if "prof" in watch:
            watch.pop("prof").stop()
        FA.BOUNDED_SCORES = bounded
    return paths, rates


# Phase 21: the dVAE step's loss against a float64 recomputation on the card
# (the same weights, images and Gumbel draws): the f32 forward rounds each
# conv, the codebook product and the softmax over 8192 tokens, ~1e-6
# relative; the card's convolutions run without TF32 (the tokenizer's own
# precision), which would cost ~1e-3.
DVAE_LOSS_REL_BOUND = 1e-4
# an f32 token may differ from the float64 one only where the float64 top-two
# gap is below twice the largest |f32 − f64| logit difference of the batch
# (two logits each off by at most that much can swap)
TOKEN_GAP_FACTOR = 2.0
# phase 21's images, test images, batch, depth, steps an epoch and codebook
# size (a CPU rehearsal may shrink them)
PHASE21_SIZES = (1024, 256, 128, 12, 4, 8192)


def _save_dalle_pickles(torch, vae, directory):
    """Write a ``models.dalle_vae.DalleVAE``'s encoder and decoder as
    OpenAI's pickles are laid out: ``encoder.pkl`` / ``decoder.pkl`` in
    ``directory``, each a pickled module object of the classes
    ``dall_e.encoder.Encoder`` (``EncoderBlock``), ``dall_e.decoder.Decoder``
    (``DecoderBlock``) and ``dall_e.utils.Conv2d``, stand-ins registered for
    the write and removed after it (``sys.modules`` is left as it was), for
    the driver's ``load_dalle_pickle_state_dict`` to read back."""
    import copy
    import types

    from uncertainty_vit_tpu_torch.models import dalle_vae as DV

    names = ("dall_e", "dall_e.utils", "dall_e.encoder", "dall_e.decoder")
    modules = {name: types.ModuleType(name) for name in names}

    def stand_in(module, name):
        cls = type(name, (torch.nn.Module,), {"__module__": module, "__qualname__": name})
        setattr(modules[module], name, cls)
        return cls

    conv = stand_in("dall_e.utils", "Conv2d")
    saved = {name: sys.modules.get(name) for name in names}
    try:
        sys.modules.update(modules)
        for part, top, block in (("encoder", "Encoder", "EncoderBlock"),
                                 ("decoder", "Decoder", "DecoderBlock")):
            top_cls, block_cls = stand_in(f"dall_e.{part}", top), stand_in(f"dall_e.{part}", block)
            obj = copy.deepcopy(getattr(vae, part)).cpu()
            for m in obj.modules():
                if isinstance(m, DV.Conv2d):
                    m.__class__ = conv
                elif isinstance(m, DV._Block):
                    m.__class__ = block_cls
            obj.__class__ = top_cls
            torch.save(obj, os.path.join(directory, f"{part}.pkl"))
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module


def _tokens_against_f64(torch, vae, views, what):
    """The f32 tokens of ``views`` against a float64 copy of the tokenizer on
    the card: (mismatches, near ties, largest |f32 − f64| logit) after
    checking that every mismatch lies within the stated gap."""
    import copy

    from uncertainty_vit_tpu_torch.models.dvae import f32_scope

    with torch.no_grad():
        tok32 = vae.get_codebook_indices(views)
        enc = vae.encode_logits if hasattr(vae, "encode_logits") else vae.encoder
        with f32_scope():
            logits32 = enc(views).float()
        vae64 = copy.deepcopy(vae).double()
        enc64 = vae64.encode_logits if hasattr(vae64, "encode_logits") else vae64.encoder
        logits64 = enc64(views.double())
        del vae64
    err = float((logits32.double() - logits64).abs().max())
    top2 = logits64.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).reshape(tok32.shape)
    tok64 = logits64.argmax(dim=-1).reshape(tok32.shape)
    mismatch = tok32 != tok64
    near = gap <= TOKEN_GAP_FACTOR * err
    n_bad = int((mismatch & ~near).sum())
    print(f"  {what}: {tok32.numel()} f32 tokens against a float64 copy of the tokenizer on the "
          f"card: {int(mismatch.sum())} differ, all where the float64 top-two gap <= "
          f"{TOKEN_GAP_FACTOR}·max|f32 − f64| = {TOKEN_GAP_FACTOR * err:.3e} ({int(near.sum())} "
          f"such near ties, {n_bad} mismatches outside them); smallest gap "
          f"{float(gap.min()):.3e}; {len(torch.unique(tok32))} distinct tokens", flush=True)
    check(n_bad == 0, f"{what}: {n_bad} f32 tokens differ from float64 beyond the gap bound")
    return int(mismatch.sum()), int(near.sum()), err


def phase21(torch, FA, dev, step_rates, cyclical_rates):
    """The BEiT pretraining drivers and the dVAE trainer on the card over
    seeded 32x32 CIFAR-100 images (21a cli.train_dvae; 21b cli.pretrain_beit
    at the MIM recipe with the full-width DALL-E tokenizer from seeded
    pickles; 21c cli.pretrain_joint with 21a's tokenizer; 21d 21b's last
    checkpoint through cli.finetune --eval). step_rates: phase 4's; and
    cyclical_rates: phase 20's driver rates, for the rates beside. Returns
    the launches of each path."""
    import copy
    import tempfile

    import numpy as np

    from uncertainty_vit_tpu_torch.cli import builders as B
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.cli import pretrain_beit as PB
    from uncertainty_vit_tpu_torch.cli import pretrain_cyclical as PC
    from uncertainty_vit_tpu_torch.cli import pretrain_joint as PJ
    from uncertainty_vit_tpu_torch.cli import train_dvae as TD
    from uncertainty_vit_tpu_torch.models.dalle_vae import DalleVAE
    from uncertainty_vit_tpu_torch.models.dvae import DiscreteVAE
    from uncertainty_vit_tpu_torch.models.layers import layer_norm
    from uncertainty_vit_tpu_torch.ops import augment as A
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import losses as L
    from uncertainty_vit_tpu_torch.ops import masking as M
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.train import engine_cyclical as EC
    from uncertainty_vit_tpu_torch.train import engine_mim as EM
    from uncertainty_vit_tpu_torch.train.ema import cyclical_ema_decay
    from uncertainty_vit_tpu_torch.utils import checkpoint as C

    n_train, n_test, bs, depth, spe, vocab = PHASE21_SIZES
    rs = np.random.RandomState(21)
    train_images = rs.randint(0, 256, (n_train, 32, 32, 3), dtype=np.uint8)
    test_images = rs.randint(0, 256, (n_test, 32, 32, 3), dtype=np.uint8)

    def counts():
        # inside attention_on_plain the attention wrappers are plain
        # functions, which count nothing
        return kernel_counts(FA, TQ, DO) if hasattr(FA.fused_qkv_attention_bwd, "launches") else {}

    want = {k: 0 for k in counts()}
    paths = {}
    # what the drivers do, seen through their own entry points: each call of
    # a train step (host clock, CUDA events, launches, masks, the softmax
    # mode, the views it made, the teacher around steps 0 and 1), each
    # epoch's log record, the state auto_load restored, the tokenizer built
    steps, writes, resumed, built = [], [], [], []
    watch = {"sync_check": None, "ema_check": False, "gumbel": None, "dvae_flags": []}
    saved_attrs = {(TD, "make_dvae_train_step"): TD.make_dvae_train_step,
                   (TD, "draw_gumbel"): TD.draw_gumbel, (TD, "build_model"): TD.build_model,
                   (PB, "make_mim_train_step"): PB.make_mim_train_step,
                   (PJ, "make_joint_train_step"): PJ.make_joint_train_step,
                   (PC, "JsonlLogger"): PC.JsonlLogger, (C, "auto_load"): C.auto_load,
                   (B, "build_discrete_vae"): B.build_discrete_vae}
    import_sd = C.import_torch_state_dict

    def timed_call(step, state, model, r, *args):
        """Run one driver step, recording its launches, host clock and CUDA
        events; the step under sync debug mode when watch says so."""
        r.update(step=state.step, bounded=FA.BOUNDED_SCORES)
        if watch["ema_check"] and state.step < 2:
            r["teacher_before"] = {k: v.detach().clone() for k, v in state.model_ema.items()}
        before = counts()
        checked = state.step == watch["sync_check"]
        r["t"] = time.perf_counter()
        r["events"] = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        r["events"][0].record()
        if checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            m = step(state, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        r["events"][1].record()
        after = counts()
        r.update(metrics=m, sync_checked=checked, launches={k: after[k] - before[k] for k in after})
        if "teacher_before" in r:
            r["student"] = {k: p.detach().clone() for k, p in model.named_parameters()}
            r["teacher"] = {k: v.detach().clone() for k, v in state.model_ema.items()}
        steps.append(r)
        return m

    def recording_dvae_step(model, optimizer, args, lr):
        step = saved_attrs[(TD, "make_dvae_train_step")](model, optimizer, args, lr)

        def recorded(state, images, generator):
            r = {}
            if state.step == 0:
                r.update(images=images.detach().clone(),
                         weights={k: v.detach().clone() for k, v in model.state_dict().items()},
                         tau=TD.temperature_schedule(0, args.temperature_start,
                                                     args.temperature_end,
                                                     args.temperature_anneal_steps))
                watch["gumbel"] = r
            return timed_call(step, state, model, r, images, generator)

        return recorded

    def tf32_flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    def recording_dvae_model(args, device=None):
        # the TF32 flags in force at the dVAE's first and last convolutions,
        # in the forward and (a hook on their outputs' gradients) the backward
        model = saved_attrs[(TD, "build_model")](args, device)

        def record(module, inputs, out):
            watch["dvae_flags"].append(("forward", tf32_flags()))
            out.register_hook(lambda grad: watch["dvae_flags"].append(("backward", tf32_flags())))

        for m in (model.encoder[0], model.decoder[-1]):
            m.register_forward_hook(record)
        return model

    def recording_gumbel(generator, shape):
        g = saved_attrs[(TD, "draw_gumbel")](generator, shape)
        if watch["gumbel"] is not None and "gumbel" not in watch["gumbel"]:
            watch["gumbel"]["gumbel"] = g.clone()
        return g

    def views_recorder(aug_fn, r_box):
        def aug(generator, images, valid_hw=None):
            out = aug_fn(generator, images, valid_hw)
            if r_box and "views" not in r_box[0]:
                r_box[0]["views"] = (out[0].detach().clone(), out[1].detach().clone())
            return out
        return aug

    def recording_mim_step(model, tokenizer, optimizer, lr, wd, aug_fn, **kw):
        box = []
        step = saved_attrs[(PB, "make_mim_train_step")](model, tokenizer, optimizer, lr, wd,
                                                         views_recorder(aug_fn, box), **kw)

        def recorded(state, images, masks, *rest):
            r = {"masks": masks.clone()}
            box[:] = [r] if state.step == 0 else []
            return timed_call(step, state, model, r, images, masks, *rest)

        return recorded

    def recording_joint_step(model, tokenizer, optimizer, hp, lr, wd, aug_fn, **kw):
        step = saved_attrs[(PJ, "make_joint_train_step")](model, tokenizer, optimizer, hp, lr, wd,
                                                           aug_fn, **kw)

        def recorded(state, images, masks, epoch, *rest):
            return timed_call(step, state, model, {"masks": masks.clone(), "epoch": epoch},
                              images, masks, epoch, *rest)

        return recorded

    class TimedJsonl(saved_attrs[(PC, "JsonlLogger")]):
        def write(self, record):
            writes.append(time.perf_counter())
            super().write(record)

    def recording_auto_load(output_dir, state):
        state, epoch = saved_attrs[(C, "auto_load")](output_dir, state)
        resumed.append({"epoch": epoch, "step": state.step,
                        "model": {k: v.detach().clone()
                                  for k, v in state.model.state_dict().items()},
                        "teacher": (None if state.model_ema is None else
                                    {k: v.detach().clone() for k, v in state.model_ema.items()}),
                        "optimizer": {i: {k: v.clone() for k, v in st.items()} for i, st in
                                      state.optimizer.state_dict()["state"].items()}})
        return state, epoch

    def recording_build(*a, **k):
        built.append(saved_attrs[(B, "build_discrete_vae")](*a, **k))
        return built[-1]

    def counted(path, expect, fn, *a, **k):
        reset_kernel_counts(FA, TQ, DO)
        out = fn(*a, **k)
        torch.cuda.synchronize()
        paths[path] = counts()
        exp = dict(want, **expect)
        print(f"  {path}: launches {paths[path]}", flush=True)
        check(paths[path] == exp, f"{path} launched {paths[path]}, expected {exp}")
        return out

    def finite(records, what, keys=("loss", "grad_norm")):
        for r in records:
            for k in keys:
                check(math.isfinite(float(r["metrics"][k])),
                      f"{what}: step {r['step']} {k} {float(r['metrics'][k])}")

    def ms_of(r):
        return r["events"][0].elapsed_time(r["events"][1])

    def check_resume(got, blob, spe_done, what):
        check(got["step"] == spe_done and blob["step"] == spe_done, f"{what}: resumed step")
        check(got["model"].keys() == blob["model"].keys()
              and all(torch.equal(got["model"][k], v) for k, v in blob["model"].items()),
              f"{what}: the resumed student is not the checkpoint's")
        check((got["teacher"] is None) == (blob["model_ema"] is None)
              and (got["teacher"] is None
                   or all(torch.equal(got["teacher"][k], v) for k, v in blob["model_ema"].items())),
              f"{what}: the resumed teacher is not the checkpoint's")
        saved = blob["optimizer"]["state"]
        check(got["optimizer"].keys() == saved.keys()
              and all(torch.equal(got["optimizer"][i][k], v.to(got["optimizer"][i][k].device))
                      for i, st in saved.items() for k, v in st.items()),
              f"{what}: the resumed AdamW moments are not the checkpoint's")
        return sum(len(st) for st in saved.values())

    def step0_against_plain(main, args, run0, what):
        steps.clear()
        reset_kernel_counts(FA, TQ, DO)
        with attention_on_plain(torch, FA):
            main(args)
        torch.cuda.synchronize()
        check(kernel_counts(FA, TQ, DO) == want, f"{what}: the plain-attention run launched a "
                                                 "kernel")
        m_k, m_p = run0["metrics"], steps[0]["metrics"]
        loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
        gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
        print(f"  {what} step 0, kernels vs plain attention: loss {loss_k:.6f} / {loss_p:.6f}, "
              f"grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
        check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
              f"{what}: the first loss disagrees with the plain attention's")
        check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
              f"{what}: the first grad norm disagrees with the plain attention's")
        check(torch.equal(steps[0]["masks"], run0["masks"]), f"{what}: the plain run's masks")

    def rates_of(run, n_epochs):
        return [spe * bs / (writes[e] - run[e * spe]["t"]) for e in range(n_epochs)]

    bounded = FA.BOUNDED_SCORES
    TD.make_dvae_train_step, TD.draw_gumbel, TD.build_model = (recording_dvae_step,
                                                               recording_gumbel,
                                                               recording_dvae_model)
    PB.make_mim_train_step, PJ.make_joint_train_step, PC.JsonlLogger = (
        recording_mim_step, recording_joint_step, TimedJsonl)
    C.auto_load, B.build_discrete_vae = recording_auto_load, recording_build
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_cifar100(tmp, train_images, np.arange(n_train) % 100, "train")
            write_cifar100(tmp, test_images, np.arange(n_test) % 100, "test")

            # ---------------- 21a: the dVAE trainer, 4 steps ----------------
            t21 = time.perf_counter()
            dvae_out = os.path.join(tmp, "dvae")
            args_a = TD.get_args_parser().parse_args([
                "--data_set", "CIFAR100", "--data_path", tmp, "--input_size", "112",
                "--vocab_size", str(vocab), "--codebook_dim", "512", "--dvae_num_layers", "3",
                "--dvae_hidden_dim", "64", "--batch_size", str(bs), "--num_workers", "8",
                "--epochs", "1", "--steps_per_epoch", str(spe), "--output_dir", dvae_out])
            watch.update(sync_check=spe - 1, dvae_flags=[])
            # TF32 on in cuDNN and cuBLAS, as a process may have it: the
            # trainer's step runs its forward and backward without it
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            try:
                state = counted("cli10_dvae_train", {}, TD.main, args_a)
                flags_after = tf32_flags()
            finally:
                torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            watch.update(sync_check=None)
            flags_seen = list(watch["dvae_flags"])
            check([k for k, _ in flags_seen] == ["forward", "forward", "backward", "backward"] * spe
                  and all(f == (False, False) for _, f in flags_seen)
                  and flags_after == (True, True),
                  f"21a: with TF32 on before main() the step's convolutions saw {flags_seen} and "
                  f"main() left {flags_after}")
            run_a = list(steps)
            check(len(run_a) == spe and state.step == spe, f"21a: {len(run_a)} step calls")
            check(any(r["sync_checked"] for r in run_a), "21a: the sync-checked step did not run")
            finite(run_a, "21a", ("loss", "recon_loss", "kl", "perplexity"))
            r0 = run_a[0]
            m64 = DiscreteVAE(112, vocab, 512, 3, 64, device=dev).double()
            m64.load_state_dict(r0["weights"])
            with torch.no_grad():
                x = r0["images"].double()
                recon, logits = m64(x, r0["tau"], r0["gumbel"].double())
                logp = torch.log_softmax(logits, dim=-1)
                kl = math.log(vocab) + torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))
                loss64 = float(torch.mean((recon - x) ** 2) + args_a.kl_weight * kl)
            del m64, recon, logits, logp
            loss0 = float(r0["metrics"]["loss"])
            rel = abs(loss0 - loss64) / abs(loss64)
            step_ms = [ms_of(r) for r in run_a]
            print(f"  21a dVAE at 112, vocab {vocab}, codebook 512, 3 layers, hidden 64, batch "
                  f"{bs}: ms a step (CUDA events) {[round(v, 3) for v in step_ms]}; perplexity "
                  f"{[round(float(r['metrics']['perplexity']), 2) for r in run_a]}, used fraction "
                  f"{[round(float(r['metrics']['codebook_used_frac']), 4) for r in run_a]}; step 0 "
                  f"loss {loss0:.7f} against {loss64:.7f} in float64 on the card (same weights, "
                  f"images, Gumbel draws, tau {r0['tau']}): relative {rel:.2e} (bound "
                  f"{DVAE_LOSS_REL_BOUND}); step {spe - 1} under sync debug mode; TF32 on in "
                  f"cuDNN and cuBLAS before main(), off at all {len(flags_seen)} forward and "
                  f"backward hooks of the first and last convolutions, on again after", flush=True)
            check(rel <= DVAE_LOSS_REL_BOUND, "21a: step 0's loss disagrees with float64")
            dvae_pth = os.path.join(dvae_out, "checkpoint-dvae-weights.pth")
            check(os.path.isfile(dvae_pth) and os.path.isfile(
                os.path.join(dvae_out, "checkpoint-0.pth")), "21a: the checkpoints")
            with open(os.path.join(dvae_out, "log.txt")) as f:
                log_a = [json.loads(line) for line in f]
            check(len(log_a) == 1 and set(log_a[0]) == {"epoch"} | {
                f"train_{k}" for k in ("loss", "recon_loss", "kl", "perplexity",
                                       "codebook_used_frac", "temperature")}, f"21a log {log_a}")
            # where a dVAE step's time goes: its kernels over 3 steps after one
            # (torch.profiler), on the trained state and step 0's images
            dvae_step = saved_attrs[(TD, "make_dvae_train_step")](
                state.model, state.optimizer, args_a, lambda _: args_a.min_lr)
            gen_a = torch.Generator(device=dev).manual_seed(7)
            split = kernel_split(torch, lambda: dvae_step(state, r0["images"], gen_a), 3)
            top = sorted(split.items(), key=lambda kv: -kv[1])[:8]
            print(f"  21a a dVAE step's kernels (torch.profiler, 3 steps after one): "
                  f"{sum(split.values()):.2f} ms a step; top (ms): "
                  f"{json.dumps({k[:60]: round(v, 3) for k, v in top})}", flush=True)
            del state, run_a, r0, dvae_step
            steps.clear()
            watch["gumbel"] = None
            print(f"  21a took {time.perf_counter() - t21:.1f} s", flush=True)

            # ---------------- 21b: BEiT MIM, DALL-E tokenizer ----------------
            t21 = time.perf_counter()
            dalle_dir = os.path.join(tmp, "dalle")
            os.makedirs(dalle_dir)
            src = DalleVAE(112, vocab, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(21))
            t0 = time.perf_counter()
            _save_dalle_pickles(torch, src, dalle_dir)
            n_src = sum(p.numel() for p in src.parameters())
            print(f"  full-width DALL-E tokenizer (n_hid 256, vocab {vocab}, {n_src / 1e6:.1f}M "
                  f"parameters, seeded) pickled through stand-in dall_e.* classes in "
                  f"{time.perf_counter() - t0:.1f} s: "
                  f"{[os.path.getsize(os.path.join(dalle_dir, f)) >> 20 for f in ('encoder.pkl', 'decoder.pkl')]} MiB",
                  flush=True)
            out_b = os.path.join(tmp, "mim")

            def args_b(out_dir, *extra):
                # the MIM recipe (BASELINE.md:36, RECIPES.md:54-65) at its
                # per-GPU batch
                return PB.get_args_parser().parse_args([
                    "--model", "beit_base_patch16_224_8k_vocab", "--input_size", "224",
                    "--data_set", "CIFAR100", "--data_path", tmp, "--batch_size", str(bs),
                    "--num_workers", "8", "--output_dir", out_dir, "--steps_per_epoch", str(spe),
                    "--save_ckpt_freq", "2", "--lr", "1.5e-3", "--warmup_epochs", "10",
                    "--num_mask_patches", "75", "--second_input_size", "112",
                    "--vocab_size", str(vocab), "--clip_grad", "3.0", "--discrete_vae_type", "dall-e",
                    "--discrete_vae_weight_path", dalle_dir, *extra])

            per_mim = dict(want, K1=depth, K2=depth)
            watch.update(sync_check=spe + 1)
            FA.BOUNDED_SCORES = True  # as phase 4 and the finetune driver left it
            writes.clear()
            t0 = time.perf_counter()
            state = counted("cli10_mim_train", {"K1": depth * 2 * spe, "K2": depth * 2 * spe},
                            PB.main, args_b(out_b, "--epochs", "2"))
            main_s = time.perf_counter() - t0
            watch.update(sync_check=None)
            run_b = list(steps)
            vae = built[-1]
            check(isinstance(vae, DalleVAE)
                  and all(torch.equal(v, src.state_dict()[k]) for k, v in vae.state_dict().items()),
                  "21b: the driver's tokenizer is not the pickles' DALL-E network")
            del src
            check(len(run_b) == 2 * spe and state.step == 2 * spe, f"21b: {len(run_b)} steps")
            for r in run_b:
                check(r["launches"] == per_mim, f"21b step {r['step']} launched {r['launches']}")
                check(r["bounded"] is False, f"21b step {r['step']} ran the bounded softmax")
            check(not FA.BOUNDED_SCORES, "21b: the driver left BOUNDED_SCORES on")
            finite(run_b, "21b", ("loss", "mlm_acc", "grad_norm"))
            check(any(r["sync_checked"] for r in run_b), "21b: the sync-checked step did not run")
            for r in run_b:
                host = M.make_blockwise_masks(EC.mask_generator(0, r["step"]), bs, (14, 14), 75, 16)
                check(torch.equal(r["masks"], torch.from_numpy(host).to(dev)),
                      f"21b step {r['step']}'s masks are not the host op's")
            with open(os.path.join(out_b, "log.txt")) as f:
                log_b = [json.loads(line) for line in f]
            check([r["epoch"] for r in log_b] == [0, 1] and all(
                set(r) == {"epoch", "loss", "mlm_acc", "grad_norm", "lr"} for r in log_b),
                f"21b log.txt: {log_b}")
            rates_b = rates_of(run_b, 2)
            print("  21b losses " + ", ".join(f"{float(r['metrics']['loss']):.5f}" for r in run_b)
                  + "; mlm_acc " + ", ".join(f"{float(r['metrics']['mlm_acc']):.4f}" for r in run_b)
                  + "; grad norms " + ", ".join(f"{float(r['metrics']['grad_norm']):.4f}"
                                               for r in run_b)
                  + f"; every step K1 {depth}, K2 {depth}, no other kernel, the exact softmax "
                  f"though BOUNDED_SCORES was on before main(); step {spe + 1} under sync debug "
                  f"mode; the masks of all {len(run_b)} steps the host op's", flush=True)
            print(f"  21b driver MIM rate from images (information only; host clock from an "
                  f"epoch's first step call to its log record): {rates_b} img/s (epoch 0 "
                  f"includes the first call's warm-up); ms a step (CUDA events, queue time "
                  f"included) {[round(ms_of(r), 2) for r in run_b]}; phase 4's finetune "
                  f"step-only rate in this call: kernel {step_rates['kernel']} img/s; main() "
                  f"with model builds, pickles and checkpoint {main_s:.2f} s", flush=True)
            views = run_b[0]["views"]
            _tokens_against_f64(torch, vae, views[1][:32], "21b DALL-E tokens of step 0's view")

            # --- step 0 on the plain attention
            step0_against_plain(PB.main, args_b(os.path.join(tmp, "mim_plain"), "--epochs", "1",
                                                 "--steps_per_epoch", "1", "--no_save_ckpt",
                                                 "--no_auto_resume"), run_b[0], "21b")

            # --- the two views on the card against the CPU's, on the driver's
            # first batch with the draws of its step 0
            loader, _ = B.build_loaders(args_b(out_b), is_train=True, letterbox_ok=True)
            loader.set_epoch(0)
            first = next(iter(loader))[0]
            draws = A.draw_pretrain_two_view(EC.step_generators(0, 0, dev).augment, bs)
            u8 = torch.from_numpy(first).to(dev)
            kw = dict(second_interpolation="bicubic")
            card = A.pretrain_two_view_batch(draws, u8, 224, 112, discrete_vae_type="none", **kw)
            cpu = A.pretrain_two_view_batch(draws.to("cpu"), torch.from_numpy(first), 224, 112,
                                            discrete_vae_type="none", **kw)
            crop_diff = (card[1].cpu() - cpu[1]).abs().max().item()
            diff = (card[0].cpu() - cpu[0]).abs()
            near = (diff > AUG_NEAR_ATOL).float().mean().item()
            flips = (diff > AUG_FLIP_ATOL).float().mean().item()
            same = A.pretrain_two_view_batch(draws, u8, 224, 112, discrete_vae_type="dall-e", **kw)
            check(torch.equal(same[0], views[0]) and torch.equal(same[1], views[1]),
                  "21b: the driver's step-0 views are not the transform's on its draws")
            print(f"  21b two views {tuple(first.shape)} -> {tuple(card[0].shape)} and "
                  f"{tuple(card[1].shape)}, card vs CPU on the same draws: the tokenizer view "
                  f"(jitter, flip, crop, in [0, 1]) max|diff| {crop_diff:.3e} (bound "
                  f"{AUG_CROP_ATOL}); the student view max|diff| {diff.max().item():.3e}, share "
                  f"beyond {AUG_NEAR_ATOL} {near:.2e} (bound {AUG_NEAR_SHARE}), beyond "
                  f"{AUG_FLIP_ATOL:.4f} {flips:.2e} (bound {AUG_FLIP_SHARE}); the driver's step-0 "
                  f"views equal the transform's on its draws", flush=True)
            check(crop_diff <= AUG_CROP_ATOL, "21b: the tokenizer view on the card disagrees")
            check(near <= AUG_NEAR_SHARE and flips <= AUG_FLIP_SHARE,
                  "21b: the student view on the card disagrees with the CPU's")
            del card, cpu, same, draws

            # --- --epochs 3 auto-resumes at epoch 2 from checkpoint-1.pth
            steps.clear()
            resumed.clear()
            args3 = args_b(out_b, "--epochs", "3")
            state = counted("cli10_mim_train_resume", {"K1": depth * spe, "K2": depth * spe},
                            PB.main, args3)
            check(len(resumed) == 1 and resumed[0]["epoch"] == 2, "21b: auto-resume")
            blob = torch.load(os.path.join(out_b, "checkpoint-1.pth"), map_location=dev,
                              weights_only=False)
            n_opt = check_resume(resumed[0], blob, 2 * spe, "21b")
            lr3, _, _ = B.build_lr_schedules(args3, spe)
            check(steps[0]["step"] == 2 * spe and steps[0]["metrics"]["lr"] == lr3(2 * spe),
                  "21b: the resumed run's first lr")
            finite(steps, "21b resumed", ("loss", "mlm_acc", "grad_norm"))
            print(f"  21b --epochs 3 resumed at epoch 2, step {2 * spe}: "
                  f"{len(resumed[0]['model'])} student and {n_opt} AdamW tensors equal to "
                  f"checkpoint-1.pth's (no teacher); first lr {steps[0]['metrics']['lr']:.6e}",
                  flush=True)
            del blob
            resumed.clear()

            # --- where a MIM step's time goes, by part (CUDA events; the masks
            # by the host clock), on the resumed run's state and a batch
            model, opt = state.model, state.optimizer
            gens = EC.step_generators(0, 99, dev)
            aug_fn = PB.two_view_augment(args3)
            images, vae_images = aug_fn(gens.augment, u8)
            masks = torch.from_numpy(M.make_blockwise_masks(EC.mask_generator(0, 99), bs,
                                                            (14, 14), 75, 16)).to(dev)
            tokens = vae.get_codebook_indices(vae_images)

            def student_fwd_bwd():
                model.train()
                loss, _ = L.masked_mim_cross_entropy(model(images, masks, generator=gens.model),
                                                     tokens, masks)
                opt.zero_grad()
                loss.backward()

            with torch.no_grad():
                trunk, _, _ = super(type(model), model).forward(images, gens.model, False,
                                                                 bool_masked_pos=masks)
            trunk = trunk.detach().requires_grad_(True)
            head_params = [model.norm.weight, model.norm.bias, model.lm_head.weight,
                           model.lm_head.bias]

            def head_and_loss():
                x = layer_norm(model.norm, trunk)[:, 1:]
                logits = torch.nn.functional.linear(x.to(model.dtype),
                                                    model.lm_head.weight.to(model.dtype),
                                                    model.lm_head.bias.to(model.dtype)).float()
                loss, _ = L.masked_mim_cross_entropy(logits, tokens, masks)
                torch.autograd.grad(loss, [trunk] + head_params)

            student_fwd_bwd()
            parts = {
                "transform": cuda_ms(lambda: aug_fn(gens.augment, u8), 10),
                "tokenizer_f32": cuda_ms(lambda: vae.get_codebook_indices(vae_images), 5),
                "student_forward_backward": cuda_ms(student_fwd_bwd, 5),
                "head_and_loss_fwd_bwd": cuda_ms(head_and_loss, 10),
                "adamw_clip": cuda_ms(lambda: opt.step(1e-3, 0.05), 10),
            }
            parts["adamw_clip_kernels"] = sum(
                kernel_split(torch, lambda: opt.step(1e-3, 0.05), 5).values())
            t = time.perf_counter()
            for i in range(10):
                M.make_blockwise_masks(EC.mask_generator(0, i), bs, (14, 14), 75, 16)
            parts["masks_host"] = (time.perf_counter() - t) * 100
            # the tokenizer in other precisions, alone (information only: the
            # drivers keep f32): its encoder under flags of the smoke's own
            cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul

            def tokens_in(prec):
                cudnn.allow_tf32 = matmul.allow_tf32 = prec == "tf32"
                try:
                    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16,
                                                         enabled=prec == "bfloat16"):
                        return vae.encoder.logits_nchw(vae_images).argmax(dim=1).reshape(bs, -1)
                finally:
                    cudnn.allow_tf32 = matmul.allow_tf32 = False

            agree = {}
            for prec in ("tf32", "bfloat16"):
                parts[f"tokenizer_{prec}"] = cuda_ms(lambda: tokens_in(prec), 5)
                agree[prec] = (tokens_in(prec) == tokens).float().mean().item()
            # with TF32 on in the process, the driver's tokenizer call still
            # runs its convolutions without it
            seen = []
            hook = vae.encoder.blocks.input.register_forward_hook(
                lambda *_: seen.append((cudnn.allow_tf32, matmul.allow_tf32)))
            cudnn.allow_tf32 = matmul.allow_tf32 = True
            try:
                own = vae.get_codebook_indices(vae_images)
                after = (cudnn.allow_tf32, matmul.allow_tf32)
            finally:
                cudnn.allow_tf32 = matmul.allow_tf32 = False
                hook.remove()
            check(seen == [(False, False)] and after == (True, True),
                  f"21b: with TF32 on in the process the tokenizer ran under {seen} and left "
                  f"{after}")
            step_ms = bs * 1000 / rates_b[1]
            dev_sum = sum(parts[k] for k in ("transform", "tokenizer_f32",
                                             "student_forward_backward", "adamw_clip_kernels"))
            print(f"  21b a MIM step's parts at batch {bs}, ms (CUDA events; masks_host by the "
                  f"host clock, made a batch ahead on the host; head_and_loss_fwd_bwd is norm, "
                  f"lm_head and the cross-entropy over [{bs}, 196, {vocab}] with their backward, "
                  f"inside student_forward_backward): "
                  f"{json.dumps({k: round(v, 3) for k, v in parts.items()})}; transform + "
                  f"tokenizer + student + AdamW kernels {dev_sum:.2f} ms against the driver's "
                  f"{step_ms:.2f} ms a step (epoch 1); token agreement with f32 under tf32 "
                  f"{agree['tf32']:.5f}, under bfloat16 {agree['bfloat16']:.5f}; with TF32 on in "
                  f"the process the driver's tokenizer call ran its convolutions without it, "
                  f"tokens equal to f32's: {bool(torch.equal(own, tokens))}", flush=True)
            del state, model, opt, trunk, tokens, own, images, vae_images, views

            # --- one int8 driver step (K6 and K7 as phase 12 counts them)
            steps.clear()
            counted("cli10_mim_int8_train", {"K1": depth, "K2": depth, "K6": 8 * depth,
                                             "K7": 4 * depth},
                    PB.main, args_b(os.path.join(tmp, "mim_int8"), "--quant", "int8", "--epochs",
                                    "1", "--steps_per_epoch", "1", "--no_save_ckpt",
                                    "--no_auto_resume"))
            finite(steps, "21b int8", ("loss", "grad_norm"))
            print(f"  21b --quant int8 step: loss {float(steps[0]['metrics']['loss']):.5f}, grad "
                  f"norm {float(steps[0]['metrics']['grad_norm']):.4f}", flush=True)
            del vae
            built.clear()
            print(f"  21b took {time.perf_counter() - t21:.1f} s", flush=True)

            # ---------------- 21c: joint cyclical+BEiT, 21a's tokenizer ----------
            t21 = time.perf_counter()
            steps.clear()
            writes.clear()
            out_c = os.path.join(tmp, "joint")

            def args_c(out_dir, *extra):
                # phase 20's cyclical recipe plus --vae_loss_weight 30
                return PJ.get_args_parser().parse_args([
                    "--model", "beit_base_patch16_224", "--input_size", "224",
                    "--data_set", "CIFAR100", "--data_path", tmp, "--batch_size", str(bs),
                    "--num_workers", "8", "--output_dir", out_dir, "--steps_per_epoch", str(spe),
                    "--save_ckpt_freq", "2", "--lr", "2e-3", "--warmup_epochs", "1",
                    "--num_mask_patches", "120", "--ema_decay", "0.9998",
                    "--ema_decay_init", "0.999", "--clip_grad", "3.0", "--drop_path", "0.25",
                    "--attn_drop_rate", "0.05", "--target_layers", "[6,7,8,9,10,11]",
                    "--layer_scale_init_value", "0.1", "--vae_loss_weight", "30",
                    "--second_input_size", "112", "--vocab_size", str(vocab),
                    "--discrete_vae_type", "customized", "--discrete_vae_weight_path", dvae_pth,
                    *extra])

            watch.update(ema_check=True)
            args_c2 = args_c(out_c, "--epochs", "2")
            FA.BOUNDED_SCORES = True
            state = counted("cli10_joint_train", {"K1": 2 * depth * 2 * spe,
                                                  "K2": depth * 2 * spe}, PJ.main, args_c2)
            watch.update(ema_check=False)
            run_c = list(steps)
            ref = torch.load(dvae_pth, weights_only=False)["model"]
            vae = built[-1]
            check(isinstance(vae, DiscreteVAE) and all(
                torch.equal(v.cpu(), ref[k]) for k, v in vae.state_dict().items()),
                "21c: the driver's tokenizer is not 21a's exported weights")
            per_joint = dict(want, K1=2 * depth, K2=depth)
            for r in run_c:
                check(r["launches"] == per_joint, f"21c step {r['step']} launched {r['launches']}")
                check(r["bounded"] is False, f"21c step {r['step']} ran the bounded softmax")
            finite(run_c, "21c", ("loss", "loss_cyc", "loss_beit", "grad_norm"))
            ws = [r["metrics"]["beit_weight"] for r in run_c]
            check(ws == [1.0] * spe + [EM.beit_weight(1, 30)] * spe
                  and abs(ws[-1] - 29 / 30) < 1e-7, f"21c beit_weight {ws}")
            for r in run_c[:2]:
                d = cyclical_ema_decay(r["step"], args_c2.ema_decay, args_c2.ema_decay_init,
                                       args_c2.ema_start_at)
                worst, moved = 0.0, 0.0
                for k, e0 in r["teacher_before"].items():
                    exp = e0.double() * d + r["student"][k].double() * (1.0 - d)
                    err = float((r["teacher"][k].double() - exp).abs().max())
                    worst = max(worst, err / max(float(exp.abs().max()), 1e-30))
                    moved = max(moved, float((r["teacher"][k] - e0).abs().max()))
                print(f"  21c teacher after step {r['step']} against d·e + (1 - d)·m on copies in "
                      f"float64 (d = {d!r}): worst tensor's max|diff| / max|expected| "
                      f"{worst:.3e} (bound {EMA_REL_BOUND}); it moved by up to {moved:.3e}",
                      flush=True)
                check(worst <= EMA_REL_BOUND, f"21c: the teacher after step {r['step']}")
            check(moved > 0, "21c: the teacher did not move at step 1")
            for r in run_c:
                for k in ("teacher_before", "student", "teacher"):
                    r.pop(k, None)
            rates_c = rates_of(run_c, 2)
            print("  21c losses " + ", ".join(f"{float(r['metrics']['loss']):.5f}" for r in run_c)
                  + "; loss_cyc " + ", ".join(f"{float(r['metrics']['loss_cyc']):.5f}"
                                            for r in run_c)
                  + "; loss_beit " + ", ".join(f"{float(r['metrics']['loss_beit']):.5f}"
                                             for r in run_c)
                  + f"; beit_weight {ws}; every step K1 {2 * depth}, K2 {depth}, the exact "
                  f"softmax", flush=True)
            print(f"  21c driver joint rate from images (information only): {rates_c} img/s; ms "
                  f"a step (CUDA events) {[round(ms_of(r), 2) for r in run_c]}; phase 20's "
                  f"cyclical driver rate in this call {cyclical_rates} img/s", flush=True)
            _tokens_against_f64(torch, vae, torch.rand(32, 112, 112, 3, device=dev,
                                                       generator=torch.Generator(
                                                           device=dev).manual_seed(5)),
                                "21c in-repo dVAE tokens")
            step0_against_plain(PJ.main, args_c(os.path.join(tmp, "joint_plain"), "--epochs", "1",
                                                "--steps_per_epoch", "1", "--no_save_ckpt",
                                                "--no_auto_resume"), run_c[0], "21c")
            del state, vae, ref
            built.clear()
            print(f"  21c took {time.perf_counter() - t21:.1f} s", flush=True)

            # ---------------- 21d: the hand-off to the finetune driver ----------
            t21 = time.perf_counter()
            imports = []

            def recording_import(sd, template, *a, **k):
                result = import_sd(sd, template, *a, **k)
                imports.append({"template": {k_: v.detach().cpu() for k_, v in template.items()},
                                "result": result})
                return result

            pth = os.path.join(out_b, "checkpoint-2.pth")
            C.import_torch_state_dict = recording_import
            try:
                res = counted("cli10_finetune_eval", {"K1": depth * 2}, FT.main,
                              FT.get_args_parser().parse_args([
                                  "--model", "beit_base_patch16_224", "--input_size", "224",
                                  "--data_set", "CIFAR100", "--data_path", tmp, "--num_workers",
                                  "8", "--batch_size", str(bs), "--finetune", pth, "--eval",
                                  "--output_dir", os.path.join(tmp, "ft")]))
            finally:
                C.import_torch_state_dict = import_sd
            check(len(imports) == 1, f"21d: {len(imports)} imports")
            _, missing, unused = imports[0]["result"]
            _, cpu_missing, cpu_unused = import_sd(C.load_torch_state_dict(pth),
                                                   imports[0]["template"])
            print(f"  21d 21b's checkpoint-2.pth through cli.finetune --finetune --eval over "
                  f"{n_test} images: missing {missing}, unused {unused}; acc1 "
                  f"{res['eval']['acc1']:.3f}", flush=True)
            check(missing == cpu_missing and unused == cpu_unused,
                  f"21d: the card's import gave {missing}, {unused}; the CPU's {cpu_missing}, "
                  f"{cpu_unused}")
            check(sorted(missing) == ["fc_norm.bias", "fc_norm.weight", "head.bias", "head.weight"]
                  and sorted(unused) == ["lm_head.bias", "lm_head.weight", "mask_token",
                                         "norm.bias", "norm.weight"], "21d: the hand-off's keys")
            print(f"  21d took {time.perf_counter() - t21:.1f} s", flush=True)
    finally:
        for (module, name), value in saved_attrs.items():
            setattr(module, name, value)
        C.import_torch_state_dict = import_sd
        FA.BOUNDED_SCORES = bounded
    return paths


# Phase 22: the dist (mean+covariance) model's step 0 on a sub-batch,
# against a float64 copy of the model on the card (the same weights, inputs
# and drop-path / dropout draws): the bf16 step within phase 4's loss and
# grad-norm bounds, its Wasserstein term (max-normalized sums over the
# batch, a small difference of bf16 distances) within 5e-2; an f32 copy
# within 1e-4 (loss, terms) and 1e-3 (grad norm, f32 sums over 1e8
# products). The teacher's targets (layer-normed, O(1)): bf16 within 5e-2,
# f32 within 1e-4 (max abs). The attention's distance products at
# [128, 12, 197, 64] in f32 with TF32 requested by the process: within 1e-5
# of float64 relative to the largest distance (TF32 would give ~1e-3).
DIST_SUB = 32
DIST_WASS_REL_BOUND = 5e-2
DIST_F32_REL_BOUND = 1e-4
DIST_F32_GRAD_NORM_REL_BOUND = 1e-3
DIST_TARGET_ATOL = {"bfloat16": 5e-2, "float32": 1e-4}
DIST_DISTANCE_REL_BOUND = 1e-5


def dist_copies(torch, snapshot, cls, cfg, dev):
    """{dtype name: a copy of the model of ``snapshot``'s weights} in bf16
    (the drivers' compute dtype), f32 and float64 (parameters in float64)."""
    out = {}
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32),
                        ("float64", torch.float64)):
        m = cls(cfg, dtype, device=dev)
        m.load_state_dict(snapshot, strict=True)
        out[name] = m.double() if dtype == torch.float64 else m
    return out


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase22(torch, FA, dev, step_rates, cyclical_rates):
    """The dist (mean+covariance) model through the drivers on the card
    (22a cli.finetune --stochastic training at the finetune recipe, 22b
    --eval --stochastic of its checkpoint, 22c cli.pretrain_cyclical
    --stochastic at the cyclical recipe), over seeded 32x32 CIFAR-100
    images from seeded weights: no kernel of the port launched; step 0 on a
    sub-batch against a float64 copy; a step under sync debug mode; the
    distance's products against float64; rates beside phases 4 and 20.
    Returns the launches of each path."""
    import tempfile

    import numpy as np

    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.cli import pretrain_cyclical as PC
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals import metrics as EM
    from uncertainty_vit_tpu_torch.models.dist_vit import DistCyclicalViT, DistVisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import losses as L
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.ops.mixup import mixup_cutmix, one_hot_smooth
    from uncertainty_vit_tpu_torch.train import engine_cyclical as EC
    from uncertainty_vit_tpu_torch.train.engine_finetune import step_generators, step_seeds
    from uncertainty_vit_tpu_torch.utils import checkpoint as C

    n_train, n_test, bs, spe = 1024, 256, 128, 4
    rs = np.random.RandomState(22)
    train_images = rs.randint(0, 256, (n_train, 32, 32, 3), dtype=np.uint8)
    test_images = rs.randint(0, 256, (n_test, 32, 32, 3), dtype=np.uint8)
    cfg = get_preset("beit_base_patch16_224", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    zero = {k: 0 for k in kernel_counts(FA, TQ, DO)}
    paths = {}

    # what the drivers do, seen through their entry points: each call of a
    # train step (launches, CUDA events, metrics; at step 0 the weights and
    # the batch; one step under sync debug mode), each evaluation, each import
    steps, evals, imports, captured = [], [], [], {}
    watch = {"sync_check": None}
    make_ft, make_cyc = FT.make_dist_finetune_train_step, PC.make_cyclical_train_step
    evaluate_dist, import_sd = FT.E.evaluate_dist, C.import_torch_state_dict

    def recording(make):
        def make_step(model, *a, **k):
            step = make(model, *a, **k)
            captured["make"] = (a, k)
            captured["model"] = (type(model), model.cfg)

            def recorded(state, *args):
                if state.step == 0:
                    captured["snapshot"] = {n: v.detach().clone()
                                            for n, v in model.state_dict().items()}
                    captured["args"] = [x.clone() if isinstance(x, torch.Tensor) else x
                                        for x in args]
                before = kernel_counts(FA, TQ, DO)
                checked = state.step == watch["sync_check"]
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                r = {"step": state.step, "t": time.perf_counter(), "sync_checked": checked}
                start.record()
                if checked:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    m = step(state, *args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                end.record()
                after = kernel_counts(FA, TQ, DO)
                r.update(metrics=m, events=(start, end),
                         launches={n: after[n] - before[n] for n in after})
                steps.append(r)
                return m

            return recorded

        return make_step

    def timed_evaluate(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = evaluate_dist(*a, **k)
        torch.cuda.synchronize()
        evals.append({"t": t, "ms": (time.perf_counter() - t) * 1000, "out": out})
        return out

    def recording_import(sd, template, *a, **k):
        result = import_sd(sd, template, *a, **k)
        imports.append(result[1:])
        return result

    def counted(path, fn, *a, **k):
        reset_kernel_counts(FA, TQ, DO)
        out = fn(*a, **k)
        torch.cuda.synchronize()
        paths[path] = kernel_counts(FA, TQ, DO)
        print(f"  {path}: launches {paths[path]}", flush=True)
        check(paths[path] == zero, f"{path} launched a kernel of the port: {paths[path]}")
        return out

    def finite(records, keys, what):
        for r in records:
            for k in keys:
                check(math.isfinite(float(r["metrics"][k])),
                      f"{what}: step {r['step']} {k} {float(r['metrics'][k])}")
            check(r["launches"] == zero, f"{what}: step {r['step']} launched {r['launches']}")

    def step_ms(records):
        return [round(r["events"][0].elapsed_time(r["events"][1]), 2) for r in records]

    def against_f64(got, want, what, bounds):
        for k, b in bounds.items():
            err = _rel(got[k], want[k])
            print(f"    {what} {k}: {got[k]:.8g} vs float64 {want[k]:.8g}, relative {err:.3e} "
                  f"(bound {b})", flush=True)
            check(err <= b, f"{what}'s {k} disagrees with the float64 copy's")

    FT.make_dist_finetune_train_step = recording(make_ft)
    PC.make_cyclical_train_step = recording(make_cyc)
    FT.E.evaluate_dist, C.import_torch_state_dict = timed_evaluate, recording_import
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_cifar100(tmp, train_images, np.arange(n_train) % 100, "train")
            write_cifar100(tmp, test_images, np.arange(n_test) % 100, "test")
            pth = os.path.join(tmp, "dist.pth")
            gen = torch.Generator(device=dev).manual_seed(220)
            seeded = DistVisionTransformer(cfg, torch.bfloat16, device=dev, generator=gen)
            trunc_normal(0.2, 2.0)(seeded.rel_pos_bias.relative_position_bias_table, gen)
            trunc_normal(0.5, 2.0)(seeded.head.weight, gen)
            n_params = sum(p.numel() for p in seeded.parameters())
            torch.save({"model": {k: v.cpu() for k, v in seeded.state_dict().items()}}, pth)
            del seeded
            out = os.path.join(tmp, "out")

            # ---------------- 22a: --stochastic training ----------------
            t22 = time.perf_counter()
            # the finetune recipe (RECIPES.md:35-45) plus --stochastic, 2
            # epochs of 4 steps at its per-GPU batch
            args = FT.get_args_parser().parse_args([
                "--model", "dist_beit_base_patch16_224", "--stochastic", "--input_size", "224",
                "--data_set", "CIFAR100", "--data_path", tmp, "--batch_size", str(bs),
                "--num_workers", "8", "--finetune", pth, "--output_dir", out,
                "--steps_per_epoch", str(spe), "--epochs", "2", "--save_ckpt_freq", "2",
                "--lr", "4e-3", "--update_freq", "1", "--warmup_epochs", "10",
                "--layer_decay", "0.65", "--drop_path", "0.2", "--drop", "0.0",
                "--weight_decay", "0.0", "--mixup", "0.8", "--cutmix", "1.0",
                "--nb_classes", "100", "--target_layer", "-1"])
            watch["sync_check"] = 1
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state = counted("cli11_dist_train", FT.main, args)
            main_s = time.perf_counter() - t0
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            watch["sync_check"] = None
            run1, eval1 = list(steps), list(evals)
            keys = ("loss", "ce_loss", "wasserstein_loss", "grad_norm")
            check(len(run1) == 2 * spe and state.step == 2 * spe,
                  f"{len(run1)} step calls, state step {state.step}")
            finite(run1, keys, "--stochastic training")
            check(any(r["sync_checked"] for r in run1), "the step under sync debug mode did not run")
            check(len(imports) == 1 and imports[0] == ([], []),
                  f"the .pth import's missing / unused: {imports}")
            with open(os.path.join(out, "log.txt")) as f:
                log = [json.loads(line) for line in f]
            check([r["epoch"] for r in log] == [0, 1]
                  and all("train_wasserstein_loss" in r and "test_acc1" in r
                          and "test_loss" not in r for r in log), f"log.txt: {log}")
            for name in ("checkpoint-1.pth", "checkpoint-best.pth"):
                check(os.path.isfile(os.path.join(out, name)), f"{name} was not written")
            torch.cuda.synchronize()
            rates = [spe * bs / (eval1[e]["t"] - run1[e * spe]["t"]) for e in range(2)]
            ms = step_ms(run1)
            print("  losses " + ", ".join(f"{float(r['metrics']['loss']):.5f}" for r in run1)
                  + "; CE " + ", ".join(f"{float(r['metrics']['ce_loss']):.5f}" for r in run1)
                  + "; Wasserstein " + ", ".join(f"{float(r['metrics']['wasserstein_loss']):.4e}"
                                                 for r in run1)
                  + "; grad norms " + ", ".join(f"{float(r['metrics']['grad_norm']):.4f}"
                                               for r in run1), flush=True)
            print(f"  {n_params} parameters; a step by CUDA events (host call to the end of its "
                  f"work; epoch 0's first includes the warm-up) {ms} ms; driver rate from images "
                  f"(information only; host clock over an epoch's {spe} steps) {rates} img/s; "
                  f"phase 4's finetune step-only rate in this call {step_rates['kernel']} img/s; "
                  f"each epoch's evaluation of {n_test} images "
                  f"{[round(e['ms'], 2) for e in eval1]} ms; peak memory at batch {bs} "
                  f"{peak_gb:.2f} GiB; main() {main_s:.2f} s; step 1 ran under "
                  f"set_sync_debug_mode('error')", flush=True)

            # step 0 on a sub-batch against float64: the driver's weights
            # before step 0, the first DIST_SUB images of its batch through
            # its own transforms and mixup, the draws of its generators
            (_, hp, *_), hooks = captured["make"]
            aug_fn, prep_fn = hooks["aug_fn"], hooks["prep_fn"]
            images_u8, pos_u8, neg_u8, labels = captured["args"][:4]
            snapshot = captured.pop("snapshot")
            gens = step_generators(args.seed, 0, dev)
            sub = slice(0, DIST_SUB)
            images = aug_fn(gens.augment, images_u8[sub], None)
            pos, neg = prep_fn(pos_u8[sub]), prep_fn(neg_u8[sub])
            images, targets = mixup_cutmix(gens.mix, images, labels[sub], hp.num_classes,
                                           hp.mixup_alpha, hp.cutmix_alpha, hp.mixup_prob,
                                           hp.mixup_switch_prob, hp.label_smoothing,
                                           mode=hp.mixup_mode, cutmix_minmax=hp.cutmix_minmax)
            model_seed = step_seeds(args.seed, 0)[0]  # the step's model generator
            model_cls, model_cfg = captured.pop("model")

            def finetune_terms(model):
                acc = L.at_least_f32(model.dtype)
                g = torch.Generator(device=dev).manual_seed(model_seed)
                model.train()
                mean, cov, logits = model(images, generator=g)
                ce = torch.mean(torch.sum(-targets.to(acc) * torch.log_softmax(
                    logits.to(acc), dim=-1), dim=-1))
                with torch.no_grad():
                    pm, pc, _ = model(pos, deterministic=True)
                    nm, nc, _ = model(neg, deterministic=True)
                w = L.wasserstein_finetune_loss(*(t.to(acc) for t in (mean, cov, pm, pc, nm, nc)),
                                                hp.lambda_finetuning, hp.lambda_pvn)
                loss = ce + w
                loss.backward()
                gn = torch.sqrt(sum((p.grad.to(acc) ** 2).sum() for p in model.parameters()
                                    if p.grad is not None))
                return {"loss": float(loss), "ce_loss": float(ce),
                        "wasserstein_loss": float(w), "grad_norm": float(gn)}

            del state
            results = {}
            for name, model in dist_copies(torch, snapshot, model_cls, model_cfg, dev).items():
                results[name] = finetune_terms(model)
                del model
                torch.cuda.empty_cache()
            print(f"  22a step 0 on a sub-batch of {DIST_SUB} (the driver's weights, transforms, "
                  f"mixup and draws) against a float64 copy on the card:", flush=True)
            against_f64(results["bfloat16"], results["float64"], "bf16 (the driver's dtype)",
                        {"loss": LOSS_REL_BOUND, "ce_loss": LOSS_REL_BOUND,
                         "wasserstein_loss": DIST_WASS_REL_BOUND,
                         "grad_norm": GRAD_NORM_REL_BOUND})
            against_f64(results["float32"], results["float64"], "f32",
                        {"loss": DIST_F32_REL_BOUND, "ce_loss": DIST_F32_REL_BOUND,
                         "wasserstein_loss": DIST_F32_REL_BOUND,
                         "grad_norm": DIST_F32_GRAD_NORM_REL_BOUND})
            check(results["float64"]["wasserstein_loss"] > 0, "a zero Wasserstein term")

            # the attention's distance products at the model's shape, TF32
            # requested by the process: float32 all the same
            dg = torch.Generator(device=dev).manual_seed(221)
            qkc = [torch.randn(bs, 12, 197, 64, device=dev, generator=dg) * s
                   for s in (0.125, 1.0, 1.0, 1.0)]
            prev = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                d32 = L.wasserstein_distance_matmul(*qkc)
                m1 = torch.sigmoid(qkc[0])
                tf32_err = float(((m1 @ m1.transpose(-1, -2)).double()
                                  - m1.double() @ m1.double().transpose(-1, -2)).abs().max())
            finally:
                torch.backends.cuda.matmul.allow_tf32 = prev
            d64 = L.wasserstein_distance_matmul(*(t.double() for t in qkc))
            derr = float((d32.double() - d64).abs().max() / d64.abs().max())
            dist_ms = cuda_ms(lambda: L.wasserstein_distance_matmul(*qkc), 5)
            print(f"  the distance at [{bs}, 12, 197, 64] with TF32 on in the process: "
                  f"max|f32 - float64| / max|float64| {derr:.3e} (bound "
                  f"{DIST_DISTANCE_REL_BOUND}); one product under TF32 would differ by up to "
                  f"{tf32_err:.3e} (information); the distance's forward {dist_ms:.3f} ms",
                  flush=True)
            check(derr <= DIST_DISTANCE_REL_BOUND, "the distance's products are not float32's")
            del qkc, d32, d64, m1
            print(f"  22a took {time.perf_counter() - t22:.1f} s", flush=True)

            # ---------------- 22b: --eval --stochastic ----------------
            t22 = time.perf_counter()
            evals.clear()
            imports.clear()
            res = counted("cli11_dist_eval", FT.main, FT.get_args_parser().parse_args([
                "--model", "dist_beit_base_patch16_224", "--stochastic", "--eval",
                "--input_size", "224", "--data_set", "CIFAR100", "--data_path", tmp,
                "--batch_size", str(bs), "--num_workers", "8", "--nb_classes", "100",
                "--finetune", os.path.join(out, "checkpoint-1.pth"),
                "--output_dir", os.path.join(tmp, "eval")]))
            metrics = res["dist_eval"]
            check(set(metrics) == set(EM.classification_metrics(
                torch.zeros(2, 3), torch.zeros(2, dtype=torch.int64)))
                and all(math.isfinite(v) for v in metrics.values()), f"dist_eval: {metrics}")
            check(imports == [([], [])], f"checkpoint-1.pth's import: {imports}")
            eval_rate = n_test * 1000 / evals[0]["ms"]
            print(f"  22b --eval --stochastic of checkpoint-1.pth over {n_test} images: "
                  f"{eval_rate:.1f} img/s (host clock around the evaluation, the transform "
                  f"included); dist_eval {json.dumps({k: round(v, 5) for k, v in metrics.items()})}"
                  f"; took {time.perf_counter() - t22:.1f} s", flush=True)

            # ---------------- 22c: cli.pretrain_cyclical --stochastic ------------
            t22 = time.perf_counter()
            steps.clear()
            captured.clear()
            pargs = PC.get_args_parser().parse_args([
                "--model", "beit_base_patch16_224", "--stochastic", "--input_size", "224",
                "--data_set", "CIFAR100", "--data_path", tmp, "--batch_size", str(bs),
                "--num_workers", "8", "--output_dir", os.path.join(tmp, "pre"),
                "--steps_per_epoch", str(spe), "--epochs", "1", "--no_save_ckpt",
                "--num_mask_patches", "120", "--target_layers", "[6,7,8,9,10,11]",
                "--ema_decay", "0.9998", "--ema_start_at", "0", "--ema_decay_init", "0.999",
                "--lr", "2e-3", "--warmup_epochs", "10", "--clip_grad", "3.0",
                "--drop_path", "0.25", "--layer_scale_init_value", "1e-4",
                "--layer_results", "end", "--max_mask_patches_per_block", "196",
                "--min_mask_patches_per_block", "16", "--l1_beta", "2.0",
                "--weight_decay", "0.05", "--imagenet_default_mean_and_std", "True",
                "--loss_scale", "-1", "--mask_dropout_prob", "-1.0",
                "--post_target_layer_norm", "--attn_drop_rate", "0.05",
                "--lambda_pretraining", "1e-5"])
            watch["sync_check"] = 1
            t0 = time.perf_counter()
            pstate = counted("cli11_cyclical_train", PC.main, pargs)
            main_s = time.perf_counter() - t0
            watch["sync_check"] = None
            check(len(steps) == spe and pstate.step == spe, f"{len(steps)} cyclical steps")
            finite(steps, ("loss", "loss_cyc", "grad_norm"), "--stochastic pretraining")
            check(any(r["sync_checked"] for r in steps), "no cyclical step under sync debug mode")
            check(isinstance(pstate.model, DistCyclicalViT)
                  and isinstance(pstate.teacher, DistCyclicalViT), "the cyclical models")
            torch.cuda.synchronize()
            cms = step_ms(steps)
            with open(os.path.join(tmp, "pre", "log.txt")) as f:
                plog = [json.loads(line) for line in f]
            check(len(plog) == 1 and "train_loss" in plog[0], f"the cyclical log.txt: {plog}")
            # the host clock from step 1's call to main()'s return (the card
            # synchronized): steps 1-3, the first call's warm-up left out
            prate = (spe - 1) * bs / (t0 + main_s - steps[1]["t"])
            print("  losses " + ", ".join(f"{float(r['metrics']['loss']):.6f}" for r in steps)
                  + "; loss_cyc " + ", ".join(f"{float(r['metrics']['loss_cyc']):.6f}"
                                              for r in steps)
                  + f"; a step by CUDA events {cms} ms (step 0 includes the warm-up); "
                  f"{bs * 1000 / min(cms[1:]):.1f} img/s at the fastest step; steps 1-{spe - 1} "
                  f"to main()'s return by the host clock {prate:.1f} img/s (information only, "
                  f"an upper bound on their time) beside phase 20's driver rates "
                  f"{cyclical_rates}; main() {main_s:.2f} s", flush=True)

            # step 0 on a sub-batch against float64: the teacher's targets
            # (mean through the whole pipeline, cov through the layer norms)
            # and the student's loss terms and gradient norm
            (_, chp, *rest), _ = captured["make"]
            aug_fn = rest[2]
            images_u8, masks = captured["args"][:2]
            snapshot = captured.pop("snapshot")
            gens = EC.step_generators(pargs.seed, 0, dev)
            images = aug_fn(gens.augment, images_u8[sub], None)
            mask = masks[sub].float()
            check(not (chp.target_batch_norm or chp.target_instance_norm
                       or chp.post_target_instance_norm) and chp.mask_dropout_prob <= 0,
                  "the recipe's targets take the layer norms only")
            cseed = step_seeds(pargs.seed, 0)[0]
            model_cls, model_cfg = captured.pop("model")

            def ln(x):
                var, mu = torch.var_mean(x, dim=-1, correction=0, keepdim=True)
                return (x - mu) / torch.sqrt(var + 1e-5)

            def cyclical_terms(model):
                acc = L.at_least_f32(model.dtype)
                with torch.no_grad():
                    mean_z, cov_z = model(images, None, deterministic=True, layer_results="end")

                    def targets_of(zs):
                        vals = [ln(zs[i].to(acc)) for i in chp.target_layers]
                        return ln(sum(vals) / len(vals))

                    tm, tc = targets_of(mean_z), targets_of(cov_z)
                g = torch.Generator(device=dev).manual_seed(cseed)
                model.train()
                out_m, out_c = (t.to(acc) for t in model(images, mask, generator=g))
                diff = (out_m - tm).abs()
                elem = torch.where(diff < chp.l1_beta, 0.5 * diff * diff / chp.l1_beta,
                                   diff - 0.5 * chp.l1_beta)
                loss_cyc = (elem * mask[..., None]).sum() / (mask.sum() * elem.shape[-1])
                c = out_m.shape[-1]
                w = L.wasserstein_pretrain_loss(out_m.reshape(-1, c), out_c.reshape(-1, c),
                                                tm.reshape(-1, c), tc.reshape(-1, c),
                                                chp.lambda_pretraining, mask=mask)
                loss = loss_cyc + w
                loss.backward()
                gn = torch.sqrt(sum((p.grad.to(acc) ** 2).sum() for p in model.parameters()
                                    if p.grad is not None))
                return ({"loss": float(loss), "loss_cyc": float(loss_cyc),
                         "wasserstein": float(w), "grad_norm": float(gn)},
                        tm.double(), tc.double())

            del pstate
            cres = {}
            for name, model in dist_copies(torch, snapshot, model_cls, model_cfg, dev).items():
                cres[name] = cyclical_terms(model)
                del model
                torch.cuda.empty_cache()
            print(f"  22c step 0 on a sub-batch of {DIST_SUB} against a float64 copy on the card "
                  f"(the teacher is the student's copy at step 0):", flush=True)
            want, tm64, tc64 = cres["float64"]
            for name in ("bfloat16", "float32"):
                got, tm, tc = cres[name]
                for what, t, t64 in (("mean", tm, tm64), ("cov", tc, tc64)):
                    err = float((t - t64).abs().max())
                    print(f"    {name} teacher's {what} targets: max|diff| from float64 "
                          f"{err:.3e} (bound {DIST_TARGET_ATOL[name]}; max|target| "
                          f"{float(t64.abs().max()):.3f})", flush=True)
                    check(err <= DIST_TARGET_ATOL[name],
                          f"the {name} teacher's {what} targets disagree with float64")
            against_f64(cres["bfloat16"][0], want, "bf16 (the driver's dtype)",
                        {"loss": LOSS_REL_BOUND, "loss_cyc": LOSS_REL_BOUND,
                         "wasserstein": DIST_WASS_REL_BOUND, "grad_norm": GRAD_NORM_REL_BOUND})
            against_f64(cres["float32"][0], want, "f32",
                        {"loss": DIST_F32_REL_BOUND, "loss_cyc": DIST_F32_REL_BOUND,
                         "wasserstein": DIST_F32_REL_BOUND,
                         "grad_norm": DIST_F32_GRAD_NORM_REL_BOUND})
            check(want["wasserstein"] > 0, "a zero Wasserstein pretraining term")
            print(f"  22c took {time.perf_counter() - t22:.1f} s", flush=True)
    finally:
        FT.make_dist_finetune_train_step, PC.make_cyclical_train_step = make_ft, make_cyc
        FT.E.evaluate_dist, C.import_torch_state_dict = evaluate_dist, import_sd
        torch.cuda.set_sync_debug_mode(0)
    return paths


# phase 23: the attention variants and the optimizer tail
VARIANT_LOGIT_REL_BOUND = 5e-2
# a hard Gumbel draw's argmax is held where the float64 copy's top-two gap
# of (scores + g)/tau exceeds this times the largest difference between the
# two runs' (scores + g)/tau; below it a flip is a rounding tie, not a fault
HARD_GAP_FACTOR = 4.0
OPT_UPDATE_REL_BOUND = 1e-5
HVP_REL_BOUND = 1e-4
RESUME_REL_BOUND = 1e-3
# (variants' batch, optimizers' batch, AdaHessian batch, float64 sub-batch)
PHASE23_SIZES = (32, 32, 64, 4)
PHASE23_OPTS = ("adam", "nadam", "radam", "adadelta", "novograd", "rmsprop", "rmsproptf", "sgd",
                "momentum", "lamb", "lars", "adafactor", "adamp", "sgdp", "adahessian",
                "lookahead_adamp")


def phase23(torch, FA, dev, step_rates):
    """Slice 12 through the drivers at full width (ViT-B/16 224 from a
    seeded .pth over seeded 32x32 CIFAR-100 images): (a) cli.finetune with
    each attention variant, 2 train steps and --eval; (b) three updates of
    every --opt through cli.finetune, each against a float64 recomputation
    of the same transform on the same gradients, one name at --update_freq
    2, a resumed run; (c) one AdaHessian step through cli.finetune (and
    under --quant int8), cli.pretrain_cyclical and --stochastic, its parts
    by CUDA events, and z ⊙ Hz against float64. Returns the launches of
    each path."""
    import copy
    import tempfile

    import numpy as np

    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.cli import pretrain_cyclical as PC
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.models import layers as LY
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import attention as TA
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import losses as L
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.train import optim as TO
    from uncertainty_vit_tpu_torch.utils import checkpoint as C

    bs_v, bs_o, bs_h, sub = PHASE23_SIZES
    depth, n_test = 12, 64
    n_train = max(bs_v, bs_o, bs_h) * 8
    rs = np.random.RandomState(23)
    train_images = rs.randint(0, 256, (n_train, 32, 32, 3), dtype=np.uint8)
    test_images = rs.randint(0, 256, (n_test, 32, 32, 3), dtype=np.uint8)
    cfg = get_preset("beit_base_patch16_224", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    zero = {k: 0 for k in kernel_counts(FA, TQ, DO)}
    paths, steps, evals, passes, opt_holds = {}, [], [], [], []
    watch = {"sync": None, "opt": None, "keep_model": False}
    saved = {"ft": FT.make_finetune_train_step, "dist": FT.make_dist_finetune_train_step,
             "cyc": PC.make_cyclical_train_step, "eval": FT.E.evaluate,
             "build_ft": FT.B.build_optimizer, "hvp": TO.hutchinson_hessian_diag}

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def recording(make):
        def make_step(model, *a, **k):
            step = make(model, *a, **k)

            def recorded(state, *args, **kw):
                before = kernel_counts(FA, TQ, DO)
                checked = len(steps) == watch["sync"]
                start, end = events()
                torch.cuda.reset_peak_memory_stats()
                start.record()
                if checked:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    m = step(state, *args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                end.record()
                after = kernel_counts(FA, TQ, DO)
                steps.append({"model": model if watch["keep_model"] else None,
                              "metrics": m, "events": (start, end),
                              "sync": checked, "peak": torch.cuda.max_memory_allocated(),
                              "launches": {n: after[n] - before[n] for n in after}})
                return m

            return recorded

        return make_step

    def timed_evaluate(*a, **k):
        before = kernel_counts(FA, TQ, DO)
        start, end = events()
        start.record()
        out = saved["eval"](*a, **k)
        end.record()
        after = kernel_counts(FA, TQ, DO)
        evals.append({"out": out, "events": (start, end),
                      "launches": {n: after[n] - before[n] for n in after}})
        return out

    def timed_hvp(loss_fn, params, generator):
        before = kernel_counts(FA, TQ, DO)
        start, end = events()
        start.record()
        d = saved["hvp"](loss_fn, params, generator)
        end.record()
        after = kernel_counts(FA, TQ, DO)
        passes.append({"events": (start, end), "launches": {n: after[n] - before[n]
                                                              for n in after}})
        return d

    def ms(rec):
        torch.cuda.synchronize()
        return rec["events"][0].elapsed_time(rec["events"][1])

    def held_build(args, model, depth_):
        """build_optimizer, and each update of it against a float64
        recomputation: a float64 copy of the model and of the optimizer's
        state before the update, the same gradients (and Hessian estimate)
        cast up, the same transform."""
        opt = saved["build_ft"](args, model, depth_)
        if watch["opt"] is None:
            return opt
        shadow = saved["build_ft"](args, copy.deepcopy(model).double(), depth_)
        chain = isinstance(opt, TO.ChainOptimizer)
        step, upd = opt.step, {}

        def capture(key, apply_):
            def captured(params, updates):
                upd[key] = [u.detach().double().clone() for u in updates]
                if apply_ is not None:
                    apply_(params, updates)
            return captured

        def held_step(lr, wd, hessian=None):
            if opt.update_freq > 1 and opt.mini_step != opt.update_freq - 1:
                return step(lr, wd, hessian=hessian)
            shadow.load_state_dict(copy.deepcopy(opt.state_dict()))
            with torch.no_grad():
                for ps, p in zip(shadow.params, opt.params):
                    ps.copy_(p)
                    ps.grad = (torch.zeros_like(ps) if p.grad is None else p.grad.double())
            before = [p.detach().double().clone() for p in opt.params]
            if chain:
                opt._apply = capture("f32", type(opt)._apply.__get__(opt))
                shadow._apply = capture("f64", None)
            norm = step(lr, wd, hessian=hessian)
            shadow.step(lr, wd, hessian=None if hessian is None
                        else [h.double() for h in hessian])
            if not chain:  # torch AdamW: its update as the f32 parameters took it
                upd["f32"] = [p.detach().double() - b for p, b in zip(opt.params, before)]
                upd["f64"] = [ps.detach() - b for ps, b in zip(shadow.params, before)]
            diff = math.sqrt(sum(float((a - b).square().sum())
                                 for a, b in zip(upd["f32"], upd["f64"])))
            size = math.sqrt(sum(float(b.square().sum()) for b in upd["f64"]))
            # AdamW's update read back from the f32 parameters carries their
            # rounding, half an ulp each
            slack = 0.0 if chain else math.sqrt(sum(
                float((torch.finfo(torch.float32).eps * p.detach().double().abs() / 2)
                      .square().sum()) for p in opt.params))
            opt_holds.append({"opt": watch["opt"], "rel": diff / size, "slack": slack / size})
            check(diff <= OPT_UPDATE_REL_BOUND * size + slack,
                  f"--opt {watch['opt']}: update {len(opt_holds)} is {diff / size:.3e} of its "
                  f"norm from the float64 recomputation (slack {slack / size:.3e})")
            return norm

        opt.step = held_step
        return opt

    FT.make_finetune_train_step = recording(saved["ft"])
    FT.make_dist_finetune_train_step = recording(saved["dist"])
    PC.make_cyclical_train_step = recording(saved["cyc"])
    FT.E.evaluate, FT.B.build_optimizer, TO.hutchinson_hessian_diag = (
        timed_evaluate, held_build, timed_hvp)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_cifar100(tmp, train_images, np.arange(n_train) % 100, "train")
            write_cifar100(tmp, test_images, np.arange(n_test) % 100, "test")
            pth = os.path.join(tmp, "vitb.pth")
            write_vitb_pth(torch, dev, cfg, pth, 230)

            def args_of(out, bs, *extra, module=FT):
                common = ["--input_size", "224", "--data_set", "CIFAR100", "--data_path", tmp,
                          "--batch_size", str(bs), "--num_workers", "4", "--output_dir", out]
                if module is FT:
                    common += ["--model", "beit_base_patch16_224", "--layer_decay", "0.65",
                               "--drop_path", "0.1", "--warmup_epochs", "0",
                               "--disable_eval_during_finetuning", "--nb_classes", "100"]
                return module.get_args_parser().parse_args(common + list(extra))

            def counted(path, fn, *a):
                # the runs before hold their models and optimizers in
                # reference cycles (the held optimizer's wrapped step): free them
                gc.collect()
                torch.cuda.empty_cache()
                reset_kernel_counts(FA, TQ, DO)
                first = len(steps)
                out = fn(*a)
                torch.cuda.synchronize()
                paths[path] = kernel_counts(FA, TQ, DO)
                print(f"  {path}: launches {paths[path]}", flush=True)
                return out, steps[first:]

            # --- 23a: the attention variants -------------------------------
            print("  23a: the attention variants", flush=True)
            x = torch.randn(sub * 2, 224, 224, 3, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(231))
            for flag in ("--sinkformer", "--gumbel_softmax", "--h_sto_trans"):
                name = flag.lstrip("-")
                watch["sync"], watch["keep_model"] = len(steps) + 1, True
                state, run = counted(f"cli12_{name}_train", FT.main, args_of(
                    os.path.join(tmp, name), bs_v, flag, "--finetune", pth, "--epochs", "1",
                    "--steps_per_epoch", "2", "--no_save_ckpt"))
                check(len(run) == 2 and all(r["launches"] == zero for r in run),
                      f"{flag}: the steps launched {[r['launches'] for r in run]}: the variant "
                      "layers take no kernel of the port")
                check(run[1]["sync"], f"{flag}: the step under sync debug mode did not run")
                for r in run:
                    for k in ("loss", "grad_norm"):
                        check(math.isfinite(float(r["metrics"][k])), f"{flag}: {k} not finite")
                watch["keep_model"] = False
                step_ms = [ms(r) for r in run]
                n_eval = len(evals)
                out, _ = counted(f"cli12_{name}_eval", FT.main, args_of(
                    os.path.join(tmp, name + "_eval"), 32, flag, "--eval", "--finetune", pth))
                check(paths[f"cli12_{name}_eval"] == zero and len(evals) == n_eval + 1,
                      f"{flag} --eval launched {paths[f'cli12_{name}_eval']}")
                check(all(math.isfinite(v) for v in out["eval"].values()),
                      f"{flag} --eval: {out['eval']}")
                eval_ms = ms(evals[-1])
                print(f"    {flag}: steps {[round(t, 2) for t in step_ms]} ms, "
                      f"{bs_v * 1000 / step_ms[1]:.1f} img/s (phase 4's {step_rates['kernel']} at "
                      f"160 on the kernels); --eval of {n_test} images {eval_ms:.1f} ms, "
                      f"{n_test * 1000 / eval_ms:.1f} img/s; acc1 {out['eval']['acc1']:.4f}; "
                      f"a step under sync debug mode", flush=True)
                # the trained model's eval logits against a float64 copy on
                # the same Gumbel noise (the same generator seed)
                model = run[-1]["model"]
                copies = {}
                for dtype in (torch.float32, torch.float64):
                    copies[dtype] = VisionTransformer(model.cfg, dtype=dtype, device=dev)
                    copies[dtype].load_state_dict(model.state_dict(), strict=True)
                m64 = copies[torch.float64].double()
                record = {}

                def recording_probs(scores, generator=None, tau=1.0, hard=False, dim=-1,
                                    noise=None, _orig=TA.gumbel_softmax_probs):
                    if noise is None:
                        noise = TA.draw_gumbel(scores.shape, generator, scores.device)
                    calls = record.setdefault(record["run"], [])
                    if len(calls) < 2:  # block 0's draws: (scores + g)/tau, scores/tau
                        calls.append(((scores.double() + noise.double()) / tau,
                                      scores.double() / tau))
                    return _orig(scores, generator, tau, hard, dim, noise)

                LY.gumbel_softmax_probs = recording_probs
                try:
                    with torch.no_grad():
                        record["run"] = "bf16"
                        got = model.eval()(x[:sub], gumbel_generator=torch.Generator(
                            device=dev).manual_seed(232))
                        record["run"] = "f32"
                        got32 = copies[torch.float32].eval()(
                            x[:sub], gumbel_generator=torch.Generator(device=dev).manual_seed(232))
                        record["run"] = "f64"
                        want = m64.eval()(x[:sub].double(), gumbel_generator=torch.Generator(
                            device=dev).manual_seed(232))
                finally:
                    LY.gumbel_softmax_probs = TA.gumbel_softmax_probs
                check(bool(torch.isfinite(got).all()), f"{flag}: non-finite logits")
                if name != "h_sto_trans":
                    # the variant in f32 against float64 (held), and the
                    # driver's bf16 compute beside it
                    err = float((got32.double() - want).abs().max() / want.abs().max())
                    err_bf16 = float((got.double() - want).abs().max() / want.abs().max())
                    print(f"    {flag}: the trained weights' logits of {sub} images in f32 "
                          f"{err:.3e} of max|logit| from the float64 copy on the same noise "
                          f"(bound {VARIANT_LOGIT_REL_BOUND}); in the driver's bf16 "
                          f"{err_bf16:.3e}", flush=True)
                    check(err <= VARIANT_LOGIT_REL_BOUND and err_bf16 <= VARIANT_LOGIT_REL_BOUND,
                          f"{flag}: the logits are {err:.3e} (f32), {err_bf16:.3e} (bf16) of "
                          "max|logit| from float64")
                    continue
                # block 0's two hard draws: the keys onto the codebook
                # [B, N, H, C], then the weights [B, H, N, N]. Both runs add
                # the same f32 noise, so (scores + g)/tau differs between them
                # by the scores' error alone, held within the variants' bound
                # of max|scores|/tau. A key whose first draw flipped changes
                # its image-head's whole second draw, so the second is held
                # on the image-heads without one
                ((z0, s0), (z1, s1)), ((w0, v0), (w1, v1)) = record["bf16"], record["f64"]
                flipped = z0.argmax(-1) != w0.argmax(-1)  # [B, N, H]
                clean = ~flipped.any(dim=1)  # [B, H]
                rows = [(z0, w0, v0, torch.ones_like(flipped)),
                        (z1, w1, v1, clean[:, :, None].expand(z1.shape[:-1]))]
                for i, (z, z64, s64, valid) in enumerate(rows):
                    top2 = z64.topk(2, dim=-1).values
                    gap = top2[..., 0] - top2[..., 1]
                    err = float((z - z64).abs().amax(-1)[valid].max())
                    scale = float(s64.abs().amax(-1)[valid].max())
                    decided = (gap > HARD_GAP_FACTOR * err) & valid
                    same = z.argmax(-1) == z64.argmax(-1)
                    n_held, n_all = int(valid.sum()), z.numel() // z.shape[-1]
                    print(f"    {flag}: block 0 draw {i}: scores/tau {err:.3e} from the float64 "
                          f"copy's, {err / scale:.3e} of their max {scale:.3e} (bound "
                          f"{VARIANT_LOGIT_REL_BOUND}); argmax equal on "
                          f"{int((same & decided).sum())} of {int(decided.sum())} positions whose "
                          f"float64 top-two gap exceeds {HARD_GAP_FACTOR} x {err:.3e} (of "
                          f"{n_held} held, {n_all} in all); {int((~same).sum())} flips in all",
                          flush=True)
                    check(err <= VARIANT_LOGIT_REL_BOUND * scale,
                          f"{flag}: draw {i}'s scores are {err / scale:.3e} of their max from "
                          "float64")
                    check(bool(same[decided].all()),
                          f"{flag}: a hard draw's argmax differs from float64 beyond its gap")
                    check(2 * n_held > n_all and 2 * int(decided.sum()) > n_held,
                          f"{flag}: draw {i} decided {int(decided.sum())} of {n_held} held "
                          f"positions ({n_all} in all): not most")
                run[-1]["model"] = None
                del m64, copies, model, state

            # --- 23b: every --opt ------------------------------------------
            print("  23b: every --opt through cli.finetune, each update against float64",
                  flush=True)
            for opt_name, uf in [(n, 1) for n in PHASE23_OPTS] + [("lamb", 2)]:
                watch["opt"] = opt_name
                tag = opt_name + ("_uf2" if uf > 1 else "")
                n0 = len(opt_holds)
                _, run = counted(f"cli12_opt_{tag}", FT.main, args_of(
                    os.path.join(tmp, "opt_" + tag), bs_o, "--opt", opt_name, "--finetune", pth,
                    "--epochs", "1", "--steps_per_epoch", str(3 * uf), "--update_freq", str(uf),
                    "--clip_grad", "1.0", "--weight_decay_end", "0.1", "--no_save_ckpt"))
                check(len(run) == 3 * uf and len(opt_holds) - n0 == 3,
                      f"--opt {tag}: {len(run)} steps, {len(opt_holds) - n0} updates held")
                for r in run:
                    check(r["launches"] == dict(zero, K1=depth, K2=depth),
                          f"--opt {tag}: a step launched {r['launches']}")
                    check(math.isfinite(float(r["metrics"]["loss"])), f"--opt {tag}: loss")
                rels = [f"{h['rel']:.2e}" for h in opt_holds[n0:]]
                print(f"    --opt {tag}: K1 12 / K2 12 a step; the 3 updates {rels} of their "
                      f"norm from float64; {[round(ms(r), 1) for r in run]} ms a step", flush=True)
            watch["opt"] = None
            # a resumed run equal to the straight one: the second epoch again
            # from the straight run's checkpoint-0.pth (the same --epochs, so
            # the same schedules)
            resumed_args = ["--opt", "adafactor", "--finetune", pth, "--steps_per_epoch", "2",
                            "--save_ckpt_freq", "1", "--epochs", "2"]
            straight, _ = counted("cli12_opt_adafactor_straight", FT.main, args_of(
                os.path.join(tmp, "straight"), bs_o, *resumed_args))
            os.makedirs(os.path.join(tmp, "resumed"))
            os.replace(os.path.join(tmp, "straight", "checkpoint-0.pth"),
                       os.path.join(tmp, "resumed", "checkpoint-0.pth"))
            again, _ = counted("cli12_opt_adafactor_resume", FT.main, args_of(
                os.path.join(tmp, "resumed"), bs_o, *resumed_args))
            check(again.step == straight.step == 4, f"steps {again.step}, {straight.step}")
            # the shared rel-pos table's gradient is a scatter-add (atomics),
            # so the two runs may part in its last bits and carry that on; a
            # lost or wrong optimizer state moves the parameters by the size
            # of the epoch's own update
            ckpt = C.load_torch_state_dict(os.path.join(tmp, "resumed", "checkpoint-0.pth"))
            diff = moved = 0.0
            equal = 0
            for k, v in straight.model.state_dict().items():
                w = again.model.state_dict()[k]
                equal += int(torch.equal(v, w))
                diff += float((v.double() - w.double()).square().sum())
                moved += float((v.double() - ckpt[k].to(dev).double()).square().sum())
            rel = math.sqrt(diff / moved)
            print(f"    --opt adafactor: the second epoch auto-resumed from the straight run's "
                  f"checkpoint-0.pth: {equal} of {len(ckpt)} tensors equal to the bit, the rest "
                  f"{rel:.3e} of the epoch's update from it (bound {RESUME_REL_BOUND})",
                  flush=True)
            check(rel <= RESUME_REL_BOUND, "the resumed run parts from the straight one")
            del straight, again, ckpt

            # --- 23c: AdaHessian -------------------------------------------
            print(f"  23c: one AdaHessian step at batch {bs_h} through each engine", flush=True)

            def hessian_step(path, want, module, *argv):
                """Three AdaHessian steps through a driver; the third (warm)
                one timed, its loss read after the second step's update.
                The lr warms up over ten epochs of three steps (base·k/29 at
                step k), as the recipes warm up over thousands: the first
                update is at lr 0, the second at base/29. AdaHessian's
                update is lr·g/(|D| + eps): from seeded weights, the full
                lr at a near-zero D sent the next loss to NaN."""
                n_pass = len(passes)
                _, run = counted(path, module.main, args_of(
                    os.path.join(tmp, path), bs_h, "--opt", "adahessian", "--epochs", "1",
                    "--steps_per_epoch", "3", "--no_save_ckpt", "--warmup_epochs", "10", *argv,
                    module=module))
                check(len(run) == 3 and len(passes) == n_pass + 3,
                      f"{path}: {len(run)} steps, {len(passes) - n_pass} Hessian passes")
                for r, p in zip(run, passes[n_pass:]):
                    check(p["launches"] == zero,
                          f"{path}: the Hessian pass launched {p['launches']}")
                    check(r["launches"] == dict(zero, **want),
                          f"{path}: the step launched {r['launches']}, expected {want}")
                    check(math.isfinite(float(r["metrics"]["loss"])), f"{path}: loss not finite")
                lrs = [float(r["metrics"]["lr"]) for r in run]
                check(lrs[1] > 0, f"{path}: the lrs {lrs} leave no nonzero update before the "
                      "last loss")
                r, p = run[-1], passes[-1]
                total, hvp = ms(r), ms(p)
                print(f"    {path}: lrs {lrs}, losses "
                      f"{[round(float(q['metrics']['loss']), 5) for q in run]} (the last after "
                      f"an update at lr {lrs[1]:.3e}); the third step {total:.2f} ms = Hessian "
                      f"pass {hvp:.2f} + the rest {total - hvp:.2f} (transform, mixup, gradient, "
                      f"update; the first two {ms(run[0]):.2f}, {ms(run[1]):.2f}); peak "
                      f"{r['peak'] / 2**30:.2f} GiB; kernels {r['launches']} a step in its own "
                      "gradient, none in the pass", flush=True)
                return total, hvp

            timing = {}
            timing["finetune"] = hessian_step(
                "cli12_adahessian", {"K1": depth, "K2": depth}, FT, "--finetune", pth)
            timing["int8"] = hessian_step(
                "cli12_adahessian_int8", {"K1": depth, "K2": depth, "K6": 8 * depth,
                                          "K7": 4 * depth}, FT, "--finetune", pth,
                "--quant", "int8")
            timing["cyclical"] = hessian_step(
                "cli12_adahessian_cyclical", {"K1": 2 * depth, "K2": depth}, PC,
                "--model", "beit_base_patch16_224", "--num_mask_patches", "120",
                "--target_layers", "[6,7,8,9,10,11]", "--ema_decay", "0.9998",
                "--ema_start_at", "0", "--ema_decay_init", "0.999", "--lr", "2e-3",
                "--warmup_epochs", "10", "--clip_grad", "3.0", "--drop_path", "0.25",
                "--layer_scale_init_value", "0.1", "--layer_results", "end",
                "--max_mask_patches_per_block", "196", "--min_mask_patches_per_block", "16",
                "--attn_drop_rate", "0.05")
            timing["stochastic"] = hessian_step(
                "cli12_adahessian_stochastic", {}, FT, "--stochastic", "--model",
                "dist_beit_base_patch16_224", "--drop", "0.0")
            # the update's share, alone: the adahessian chain over ViT-B's
            # parameters on the gradient and estimate of one step
            model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev,
                                      generator=torch.Generator(device=dev).manual_seed(233))
            opt = TO.make_optimizer(model, opt_name="adahessian", weight_decay=0.05,
                                    layer_decay=0.65, depth=depth)
            grads = [torch.randn_like(p) * 1e-3 for p in opt.params]
            hess = [torch.randn_like(p) for p in opt.params]

            def update():
                for p, g in zip(opt.params, grads):
                    p.grad = g
                opt.step(1e-4, 0.05, hessian=hess)

            update_ms = cuda_ms(update, 5)
            print(f"    the adahessian update alone (86.6 M parameters): {update_ms:.3f} ms; "
                  f"the finetune step's gradient therefore "
                  f"{timing['finetune'][0] - timing['finetune'][1] - update_ms:.2f} ms",
                  flush=True)
            del model, opt, grads, hess
            # z ⊙ Hz of an f32 step on a sub-batch against a float64 copy
            # with the same z (the same generator seed)
            m32 = VisionTransformer(cfg, dtype=torch.float32, device=dev)
            state, _, _ = C.import_torch_state_dict(C.load_torch_state_dict(pth),
                                                    m32.state_dict())
            m32.load_state_dict(state, strict=True)
            m64 = VisionTransformer(cfg, dtype=torch.float64, device=dev)
            m64.load_state_dict(m32.state_dict(), strict=True)
            m64.double()
            xs = x[:sub]
            target = torch.nn.functional.one_hot(torch.arange(sub, device=dev) % 100,
                                                 100).float()

            def estimate(model, dtype):
                def loss():
                    return L.soft_target_cross_entropy(model.eval()(xs.to(dtype)),
                                                       target.to(dtype))
                return saved["hvp"](loss, list(model.parameters()),
                                    torch.Generator(device=dev).manual_seed(234))

            d32, d64 = estimate(m32, torch.float32), estimate(m64, torch.float64)
            diff = math.sqrt(sum(float((a.double() - b).square().sum()) for a, b in zip(d32, d64)))
            size = math.sqrt(sum(float(b.square().sum()) for b in d64))
            print(f"    z . Hz of an f32 step on {sub} images: {diff / size:.3e} of its norm from "
                  f"the float64 copy's (bound {HVP_REL_BOUND})", flush=True)
            check(diff <= HVP_REL_BOUND * size, "z . Hz disagrees with the float64 copy's")
            del m32, m64, d32, d64
    finally:
        FT.make_finetune_train_step = saved["ft"]
        FT.make_dist_finetune_train_step = saved["dist"]
        PC.make_cyclical_train_step = saved["cyc"]
        FT.E.evaluate, FT.B.build_optimizer, TO.hutchinson_hessian_diag = (
            saved["eval"], saved["build_ft"], saved["hvp"])
    return paths


# phase 24: the device mesh
PHASE24_MESH = (2, 1, 2)  # data 2 x model 2
PHASE24_BATCH = 32
# ViT-B/16 224 widths at 4 of its 12 blocks: the four ranks' steps hold the
# same sharding at a third of the time (the launch counts scale with it)
PHASE24_DEPTH = 4


def phase24(torch, FA, dev):
    """24a: ViT-B/16 224's widths at PHASE24_DEPTH blocks on a data 2 x
    model 2 mesh of 4 gloo ranks sharing the card against one unsharded
    process; 24b: the port's dry run at
    --devices 8. Returns the launches of each path summed over the ranks."""
    import dataclasses

    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.parallel import dryrun as DR

    saved = FA.BOUNDED_SCORES
    cfg = dataclasses.asdict(get_preset("beit_base_patch16_224", use_shared_rel_pos_bias=True,
                                        init_values=0.1, drop_path_rate=0.1,
                                        depth=PHASE24_DEPTH))
    depth = cfg["depth"]
    paths = {}
    try:
        t0 = time.perf_counter()
        report = DR.dryrun(DR.Plan(PHASE24_MESH, cfg, PHASE24_BATCH), dev)
        print(f"  24a took {time.perf_counter() - t0:.1f} s", flush=True)
        want = {"cyclical": {"K1": 2 * depth, "K2": depth, "K5": 0},
                "finetune": {"K1": depth, "K2": depth, "K5": 0},
                "dist": {"K1": 0, "K2": 0, "K5": 0}}
        phase24_report(report, "24a", want)
        for engine, res in report["engines"].items():
            paths[f"mesh_vitb_{engine}_step"] = {
                k: sum(r[k] for r in res["launches_per_rank"]) for k in ("K1", "K2", "K5")}
        t0 = time.perf_counter()
        report = DR.main(["--devices", "8"])
        print(f"  24b took {time.perf_counter() - t0:.1f} s", flush=True)
        tiny = DR.TINY["depth"]
        # the seq axis of 2 sends every attention of the token-sharded models to K5:
        # a forward and its backward each a block (the cyclical teacher's forward too)
        want = {"cyclical": {"K1": 0, "K2": 0, "K5": 3 * tiny},
                "finetune": {"K1": 0, "K2": 0, "K5": 2 * tiny},
                "dist": {"K1": 0, "K2": 0, "K5": 0}}
        phase24_report(report, "24b", want)
        for engine, res in report["engines"].items():
            paths[f"mesh_dryrun8_{engine}_step"] = {
                k: sum(r[k] for r in res["launches_per_rank"]) for k in ("K1", "K2", "K5")}
    finally:
        FA.BOUNDED_SCORES = saved
    return paths


def phase24_report(report, tag, want) -> None:
    """Prints and checks one dry run's holds, launches and seconds."""
    for engine, res in report["engines"].items():
        print(f"  {tag} {engine}: loss {res['loss']:.6f} / unsharded {res['ref_loss']:.6f} "
              f"(rel {res['loss_rel']:.3e}, bound {1e-4}); gradient norm {res['grad_norm']:.6f} / "
              f"unsharded {res['ref_grad_norm']:.6f} (rel {res['grad_norm_rel']:.3e}, bound "
              f"{1e-4}); parameters: worst excess over "
              f"rtol 1e-3 / atol 1e-4 {res['worst_excess']:.3e} ({res['worst_param']}), "
              f"ill-posed max |diff| {res['loose_max']:.3e} (bound 2e-3), well-posed share "
              f"{res['well_posed_share']:.4f}", flush=True)
        print(f"  {tag} {engine}: launches per rank {json.dumps(res['launches_per_rank'])}; "
              f"seconds of the first / second step per rank "
              f"{[round(x, 4) for x in res['seconds_per_rank']]} / "
              f"{[round(x, 4) for x in res['warm_seconds_per_rank']]} over gloo (ranks sharing "
              f"one card through host memory: not a multi-card throughput); unsharded "
              f"{res['ref_seconds']:.4f} / {res['ref_warm_seconds']:.4f} s", flush=True)
        check(res["ok"], f"{tag}: the sharded {engine} step disagrees with the unsharded one")
        for r, got in enumerate(res["launches_per_rank"]):
            check(got == want[engine], f"{tag}: rank {r}'s {engine} step launched {got}, "
                                       f"expected {want[engine]}")
    check(report["engines"]["finetune"]["precision_moved"] > 0,
          f"{tag}: the SNGP precision matrix did not move")


# Phase 25: cli.finetune's evaluations under --seq_parallel 2 at ViT-B/16
# 384. Sizes: (train images, test images, batch); the train split feeds the
# two epochs (2 steps) and the post-hoc fits, the test split every dispatch
PHASE25_SIZES = (16, 16, 8)
# T* of the ranks against one process's: the fit set's logits differ within
# LOGIT_REL_BOUND, and its NLL is flat near the minimum
PHASE25_T_LOG_BOUND = 5e-2
# the Laplace prior: the same or the neighbouring point of its 49-point grid
# on [1e-4, 1e4] (an eighth of a decade and a third apart)
PHASE25_PRIOR_LOG10_BOUND = 8.0 / 48 + 1e-9
# the dispatches that draw masks (MC-dropout folded and split, -C with it):
# rank 0's arrays against one process's, relative to their largest value. A
# query row's attention is the same arithmetic in K5 as in K3 and the window
# draws the same bits, so the H100 runs read 0; with rank 1 drawing rank 0's
# rows (window start 0) the folded MC logits read 2.2e-3, and masks from
# another --seed move the -C logits by 3.0e-2 (the check below requires
# more than this bound there, so that other masks show)
PHASE25_MC_REL_BOUND = 1e-4
PHASE25_DRAWS = ("mc_folded", "mc_split", "corrupted_mc")


def seq_eval_rank(group, device, cases, perturbations):
    """One rank of phase 25: each case's driver body (``cli.finetune.run_rank``)
    in turn with this rank's half of the tokens on the one card. Returns
    {case: {"launches" (the counts set to 0 before the run and read after),
    "reads" (the host arrays the evaluation read back through
    ``evals.collect._finish``, in order: logits, features and labels), "s"
    (host clock around the run), "mc_s" (around evaluate_mc_dropout, where
    run), "gathers" and "gather_s" (the k/v gathers' count and host clock,
    the card synchronized before each), "result" (rank 0's; None for a
    training run)}}."""
    import numpy as np
    import torch

    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.evals import collect
    from uncertainty_vit_tpu_torch.evals import robustness as R
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.parallel import seq

    R.PERTURBATIONS = perturbations
    gather, gathers = seq.gather_tokens, {"n": 0, "s": 0.0}

    def timed_gather(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = gather(*a, **k)
        torch.cuda.synchronize()
        gathers["n"], gathers["s"] = gathers["n"] + 1, gathers["s"] + time.perf_counter() - t
        return y

    seq.gather_tokens = timed_gather
    try:
        with recorded_driver(torch, np, FT, collect) as rec:
            out = {}
            for name, argv, trains in cases:
                rec["reads"], rec["mc_s"] = [], None
                gathers["n"], gathers["s"] = 0, 0.0
                torch.cuda.synchronize()
                reset_kernel_counts(FA, TQ, DO)
                t = time.perf_counter()
                res = FT.run_rank(group, FT.get_args_parser().parse_args(argv), device)
                torch.cuda.synchronize()
                out[name] = {"launches": kernel_counts(FA, TQ, DO),
                             "s": time.perf_counter() - t, "reads": rec["reads"],
                             "mc_s": rec["mc_s"], "gathers": gathers["n"],
                             "gather_s": gathers["s"], "result": None if trains else res}
                del res
                gc.collect()
    finally:
        seq.gather_tokens = gather
    return out


@contextlib.contextmanager
def recorded_driver(torch, np, FT, collect):
    """Inside, every host array the evaluations read back
    (``collect._finish``) is kept in rec["reads"], and rec["mc_s"] is the host
    clock around ``evaluate_mc_dropout``."""
    rec = {"reads": [], "mc_s": None}
    finish, mc_eval = collect._finish, FT.E.evaluate_mc_dropout

    def recorded(pending):
        value = finish(pending)
        rec["reads"].append(np.array(value))
        return value

    def timed_mc(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = mc_eval(*a, **k)
        torch.cuda.synchronize()
        rec["mc_s"] = time.perf_counter() - t
        return out

    collect._finish, FT.E.evaluate_mc_dropout = recorded, timed_mc
    try:
        yield rec
    finally:
        collect._finish, FT.E.evaluate_mc_dropout = finish, mc_eval


def phase25(torch, FA, dev):
    """Slice 15 on the card: ``cli.finetune --seq_parallel 2`` at ViT-B/16 384
    (``beit_base_patch16_384``, N = 577) from a ViT-B/16 224 .pth with a
    100-class head, over seeded 32x32 CIFAR-100 images, on two gloo ranks
    sharing the card: an --sngp --gp_layer epoch and a --het_layer epoch of 2
    steps each, then every evaluation of the slice (MC-dropout K=8 folded
    and split at 9, the SNGP and het heads from the two-rank checkpoints,
    --temp_scaling, --laplace, -C --mc_dropout, -P (at ViT-B/16 224: the
    CIFAR-P frames are resized to 256 before their crop) and
    --visualize_embedding); then each in one process. Holds each case's
    launches on each rank and in
    the one process, the arrays rank 0 read back against the one process's
    (logits within LOGIT_REL_BOUND of max|logit|, labels equal), T*, the
    Laplace prior, the epochs' losses, and that another --seed draws other
    -C MC-dropout masks. Returns the launches of each path ("cli15_seq2_":
    summed over the ranks; "cli15_": one process)."""
    import tempfile

    import numpy as np

    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.evals import collect
    from uncertainty_vit_tpu_torch.evals import robustness as R
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.parallel import seq

    n_train, n_test, bs = PHASE25_SIZES
    depth, split, k = 12, 9, 8
    fwd = n_test // bs
    rs = np.random.RandomState(25)
    perturbations = ("shot_noise",)

    def u8(n, *shape):
        return rs.randint(0, 256, (n,) + shape, dtype=np.uint8)

    def card():
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60, check=True).stdout.strip()

    want = {k_: 0 for k_ in kernel_counts(FA, TQ, DO)}
    paths = {}
    bounded, perturbation_list = FA.BOUNDED_SCORES, R.PERTURBATIONS
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_cifar100(tmp, u8(n_train, 32, 32, 3), np.arange(n_train) % 100, "train")
            write_cifar100(tmp, u8(n_test, 32, 32, 3), np.arange(n_test) % 100, "test")
            croot, proot = os.path.join(tmp, "cifar-c"), os.path.join(tmp, "cifar-p")
            os.makedirs(croot)
            os.makedirs(proot)
            # one batch of one distortion (all of it severity 1 in the
            # 10,000-rows-a-severity layout), two videos of 4 frames: one batch
            np.save(os.path.join(croot, "labels.npy"), np.arange(bs) % 100)
            np.save(os.path.join(croot, "gaussian_noise.npy"), u8(bs, 32, 32, 3))
            np.save(os.path.join(proot, "shot_noise.npy"), u8(2, bs // 2, 32, 32, 3))
            pth = os.path.join(tmp, "vitb224.pth")
            write_vitb_pth(torch, dev, get_preset(
                "beit_base_patch16_224", num_classes=100, use_shared_rel_pos_bias=True,
                use_abs_pos_emb=False, init_values=0.1), pth, 250)

            def argv(s, name, *extra, train=False, size=384):
                out = os.path.join(tmp, f"s{s}_{name}")
                return ["--model", f"beit_base_patch16_{size}", "--input_size", str(size),
                        "--data_set", "CIFAR100", "--data_path", tmp, "--num_workers", "8",
                        "--batch_size", str(bs), "--finetune", pth, "--output_dir", out,
                        *([] if train else ["--eval"]), *extra, "--seq_parallel", str(s)]

            mc = ["--mc_dropout", "--mc_dropout_forwards", str(k), "--drop", "0.1"]
            epoch = ["--epochs", "1", "--steps_per_epoch", str(n_train // bs),
                     "--disable_eval_during_finetuning", "--save_ckpt_freq", "1",
                     "--warmup_epochs", "0", "--layer_decay", "0.65", "--no_auto_resume"]
            ckpt = {h: os.path.join(tmp, f"s2_{h}_train", "checkpoint-0.pth")
                    for h in ("sngp", "het")}
            # name → (extra flags, launches a rank: K5 for one process's K3,
            # K5_bwd for its K4, K8 the same). -P runs at 224: its frames are
            # resized to 256 before the crop, so above 256 both packages
            # refuse it (ops/augment.py:eval_resize_center_crop); there one
            # process runs K1 (N = 197), the ranks K5 on 99 / 98 rows
            evals = {
                "mc_folded": (mc, dict(K5=depth * fwd, K8=2 * depth * fwd)),
                "mc_split": (mc + ["--mc_dropout_split_at", str(split), "--dropout_from_block",
                                   str(split)],
                             dict(K5=depth * fwd, K8=2 * (depth - split) * fwd)),
                "sngp": (["--sngp", "--gp_layer", "--finetune", ckpt["sngp"]],
                         dict(K5=depth * fwd)),
                "het": (["--het_layer", "--finetune", ckpt["het"]], dict(K5=depth * fwd)),
                "temp_scaling": (["--temp_scaling"], dict(K5=depth * fwd)),
                "laplace": (["--laplace"], dict(K5=depth * (n_train // bs + fwd))),
                "corrupted_mc": (["--corrupted_data", "--corruption_data_path", croot, *mc],
                                 dict(K5=depth, K8=2 * depth)),
                "perturbed": (["--perturbed_data", "--perturbation_data_path", proot],
                              dict(K5=depth)),
                "embedding": (["--visualize_embedding"], dict(K5=depth * fwd)),
            }
            steps = n_train // bs
            train_launches = dict(K5=depth * steps, K5_bwd=depth * steps)
            cases = ([(f"{h}_train", argv(2, f"{h}_train", *flags, *epoch, train=True), True)
                      for h, flags in (("sngp", ["--sngp", "--gp_layer"]),
                                       ("het", ["--het_layer"]))]
                     + [(name, argv(2, name, *extra, size=224 if name == "perturbed" else 384),
                         False) for name, (extra, _) in evals.items()])
            expect = {f"{h}_train": train_launches for h in ("sngp", "het")}
            expect.update({name: n for name, (_, n) in evals.items()})

            # --- 25a: the two ranks
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = seq.run_ranks(seq_eval_rank, 2, str(dev), cases, perturbations,
                                  timeout=600.0)
            ranks_s = time.perf_counter() - t0
            for r, res in enumerate(ranks):
                for name, run in res.items():
                    exp = dict(want, **expect[name])
                    check(run["launches"] == exp,
                          f"25a rank {r} {name} launched {run['launches']}, expected {exp}")
                    check((run["result"] is None) == (r == 1 or name.endswith("_train")),
                          f"25a rank {r} {name} returned {type(run['result'])}")
            a, b = ranks
            for name in a:
                paths[f"cli15_seq2_{name}"] = {k_: a[name]["launches"][k_]
                                               + b[name]["launches"][k_] for k_ in want}
            print(f"  25a two ranks ({card()}), launches a rank "
                  + "; ".join(f"{n}: {r['launches']}" for n, r in a.items()), flush=True)
            print(f"  25a seconds a run (host clock, model build and .pth import included): "
                  + ", ".join(f"{n} {r['s']:.2f}" for n, r in a.items())
                  + f"; the ranks ran {ranks_s:.1f} s from start to end", flush=True)
            for h in ("sngp", "het"):
                check(os.path.exists(ckpt[h]), f"25a's {h} epoch wrote no checkpoint")

            # --- 25b: one process, the same cases; the epochs without a checkpoint
            one = {}
            R.PERTURBATIONS = perturbations
            with recorded_driver(torch, np, FT, collect) as rec:
                for name, args2, trains in cases + [("corrupted_mc_seed1", argv(
                        2, "corrupted_mc_seed1", *evals["corrupted_mc"][0], "--seed", "1"),
                        False)]:
                    args1 = args2[:-2] + ["--seq_parallel", "1"]
                    args1[args1.index("--output_dir") + 1] = os.path.join(tmp, f"s1_{name}")
                    if trains:
                        args1 += ["--no_save_ckpt"]
                    rec["reads"], rec["mc_s"] = [], None
                    reset_kernel_counts(FA, TQ, DO)
                    t = time.perf_counter()
                    res = FT.main(FT.get_args_parser().parse_args(args1))
                    torch.cuda.synchronize()
                    one[name] = {"launches": kernel_counts(FA, TQ, DO),
                                 "s": time.perf_counter() - t, "reads": rec["reads"],
                                 "mc_s": rec["mc_s"], "result": None if trains else res}
                    del res
                    gc.collect()
                    torch.cuda.empty_cache()
            for name, run in one.items():
                n = expect[name.replace("_seed1", "")]
                fwd_kernel = "K1" if name == "perturbed" else "K3"
                exp = dict(want, K4=n.get("K5_bwd", 0), K8=n.get("K8", 0))
                exp[fwd_kernel] = n.get("K5", 0)
                check(run["launches"] == exp,
                      f"25b {name} launched {run['launches']}, expected {exp}")
                if name != "corrupted_mc_seed1":
                    paths[f"cli15_{name}"] = run["launches"]

            # --- the holds: rank 0's reads and results against the one process's
            worst = {}
            for name in evals:
                got, ref = a[name]["reads"], one[name]["reads"]
                check(len(got) == len(ref) > 0 and all(g.shape == w.shape for g, w in zip(got, ref)),
                      f"25 {name}: rank 0 read back {[g.shape for g in got]}, one process "
                      f"{[w.shape for w in ref]}")
                rel = 0.0
                for g, w in zip(got, ref):
                    if np.issubdtype(w.dtype, np.floating):
                        check(np.isfinite(g).all(), f"25 {name}: rank 0 read non-finite values")
                        rel = max(rel, float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                                        1e-30))
                    else:
                        check(np.array_equal(g, w), f"25 {name}: the labels differ")
                worst[name] = rel
                limit = PHASE25_MC_REL_BOUND if name in PHASE25_DRAWS else LOGIT_REL_BOUND
                check(rel <= limit,
                      f"25 {name}: rank 0's arrays differ from one process's by {rel:.3e} of "
                      f"their largest value (bound {limit})")
                if name != "embedding":  # the dump's directory: below
                    check(sorted(a[name]["result"]) == sorted(one[name]["result"]),
                          f"25 {name}: rank 0's result {a[name]['result']}")
            # -C draws its MC-dropout masks from the --seed stream (the plain
            # --mc_dropout dispatch from seed 0, as the JAX driver's does)
            other = max(float(np.abs(g - w).max()) / float(np.abs(w).max()) for g, w in zip(
                one["corrupted_mc_seed1"]["reads"], one["corrupted_mc"]["reads"])
                if np.issubdtype(w.dtype, np.floating))
            check(other > PHASE25_MC_REL_BOUND,
                  f"25: -C --mc_dropout from --seed 1 differs from --seed 0 by {other:.3e}, "
                  f"within the ranks' bound {PHASE25_MC_REL_BOUND}: a rank's wrong masks "
                  "would not show")
            t_got = a["temp_scaling"]["result"]["temp_scaling"]["temperature"]
            t_ref = one["temp_scaling"]["result"]["temp_scaling"]["temperature"]
            check(abs(math.log(t_got / t_ref)) <= PHASE25_T_LOG_BOUND,
                  f"25: T* {t_got} on the ranks, {t_ref} in one process")
            p_got = a["laplace"]["result"]["laplace"]["prior_precision"]
            p_ref = one["laplace"]["result"]["laplace"]["prior_precision"]
            check(abs(math.log10(p_got / p_ref)) <= PHASE25_PRIOR_LOG10_BOUND,
                  f"25: the Laplace prior {p_got} on the ranks, {p_ref} in one process")
            for name, flat in a["corrupted_mc"]["result"]["corruption"]["per_distortion"].items():
                check(all(math.isfinite(v) for v in flat.values()), f"25 -C {name}: {flat}")
            losses = {}
            for h in ("sngp", "het"):
                with open(os.path.join(tmp, f"s2_{h}_train", "log.txt")) as f:
                    two = [json.loads(line) for line in f]
                with open(os.path.join(tmp, f"s1_{h}_train", "log.txt")) as f:
                    single = [json.loads(line) for line in f]
                losses[h] = (two[0]["train_loss"], single[0]["train_loss"])
                check(len(two) == len(single) == 1, f"25 {h} epoch's log.txt")
                check(abs(losses[h][0] - losses[h][1]) <= LOSS_REL_BOUND * abs(losses[h][1]),
                      f"25 {h} epoch's loss on the ranks {losses[h][0]}, one process "
                      f"{losses[h][1]}")
            emb = os.path.join(tmp, "s2_embedding")
            check(a["embedding"]["result"] == emb and sorted(os.listdir(emb))[:2] == [
                "embeddings.tsv", "embeddings_labels.tsv"], "25: the embedding dump")
            print(f"  25 rank 0 against one process, max|diff| / max|value| of the arrays read "
                  f"back (bound {LOGIT_REL_BOUND}; {PHASE25_MC_REL_BOUND} for "
                  f"{', '.join(PHASE25_DRAWS)}): "
                  + ", ".join(f"{n} {v:.3e}" for n, v in worst.items())
                  + f"; -C --mc_dropout from --seed 1 against --seed 0: {other:.3e}; T* "
                  f"{t_got:.4f} / "
                  f"{t_ref:.4f}; Laplace prior {p_got:g} / {p_ref:g}; the epochs' losses "
                  + ", ".join(f"{h} {x:.5f} / {y:.5f}" for h, (x, y) in losses.items()),
                  flush=True)
            mc2, mc1 = a["mc_folded"]["mc_s"], one["mc_folded"]["mc_s"]
            print(f"  25 (information only; {card()}): MC-dropout K={k} folded over {n_test} "
                  f"images, evaluate_mc_dropout {mc2:.3f} s on the ranks ({n_test / mc2:.1f} "
                  f"img/s, {k * n_test / mc2:.1f} samples/s), {mc1:.3f} s in one process "
                  f"({n_test / mc1:.1f} img/s); the whole run {a['mc_folded']['s']:.2f} s / "
                  f"{one['mc_folded']['s']:.2f} s; one process's seconds a run: "
                  + ", ".join(f"{n} {r['s']:.2f}" for n, r in one.items()), flush=True)
            print("  25 (information only): rank 0's k/v gathers a run, count and seconds "
                  "(host clock, the card synchronized before each): "
                  + ", ".join(f"{n} {r['gathers']} {r['gather_s']:.3f} of {r['s']:.2f}"
                              for n, r in a.items()), flush=True)
    finally:
        FA.BOUNDED_SCORES, R.PERTURBATIONS = bounded, perturbation_list
    return paths


# Phase 26: the int8 trunk at the large presets, int8 training over two
# ranks, the golden-weights tool. Per path: (preset, eval batch, eval
# batches, train batch). Each model's head is drawn at std 0.5 and its
# rel-pos table at 0.2, so that the logits stand clear of the int8 noise.
PHASE26_MODELS = {"large": ("beit_large_patch16_512", 16, 2, 8),
                  "huge": ("beit_huge_patch16_224", 64, 2, 32)}
# The two-rank int8 step against one process, in f32 (--dtype float32: in
# bf16 the ranks' partial dk, dv round to bf16 before the group sum, a last
# bit that moves many rounding decisions). As
# tests/test_torch_port_int8_large.py holds it on the CPU: the loss and the
# gradient norm at rtol 1e-6 (SEQ_INT8_SUM_REL), the ranks' parameters
# after the step equal, and the gradients within 1e-3 in norm, here all of
# them together (SEQ_INT8_TOTAL_REL). The last-bit differences of the
# group's f32 sums reach every token's gradient, and a stochastic rounding
# decision within them of its threshold lands on the neighbouring int8
# value. At ViT-B's twelve blocks and 4,616 rows such flips reach nearly
# every entry of every gradient (the CPU test's narrow model had one), and
# a flip in a dgrad moves a whole row of dx by a quantum, 1/127 of the
# row's largest: the cls token's gradient sums 8 rows, so each tensor is
# held within two quanta, 2/127 in norm (SEQ_INT8_TENSOR_REL; measured
# 1.21e-2 on the cls token, 1.3e-3 and below elsewhere, 1.09e-4 over all).
# The parameters' update against one process's is printed, not held:
# Adam's first update is about lr·sign(g), so an entry whose gradient a
# flip moves across 0 moves by 2·lr.
SEQ_INT8_SUM_REL = 1e-6
SEQ_INT8_TOTAL_REL, SEQ_INT8_TENSOR_REL = 1e-3, 2.0 / 127.0


@contextlib.contextmanager
def step0_capture(torch, FT, counts):
    """Inside, the driver's first train step is recorded: its metrics and
    launches, and by parameter name its gradients, the parameters before and
    after it (on the card)."""
    rec = {}
    make_step = FT.make_finetune_train_step

    def recording_make_step(model, *a, **k):
        step = make_step(model, *a, **k)

        def recorded(state, *args, **kwargs):
            first = "metrics" not in rec
            before_n = counts()
            before = {n: p.detach().clone() for n, p in model.named_parameters()} if first \
                else None
            m = step(state, *args, **kwargs)
            if first:
                after = counts()
                rec.update(metrics={k: float(v) for k, v in m.items()},
                           launches={k: after[k] - before_n[k] for k in after}, before=before,
                           grads={n: p.grad.detach().clone() for n, p in model.named_parameters()},
                           after={n: p.detach().clone() for n, p in model.named_parameters()})
            return m

        return recorded

    FT.make_finetune_train_step = recording_make_step
    try:
        yield rec
    finally:
        FT.make_finetune_train_step = make_step


def seq_int8_held(torch, got, ref) -> dict:
    """Each gradient and each parameter update of ``got`` (step-0 records of
    step0_capture) against ``ref``, by parameter name: the share of entries
    off by more than SEQ_INT8_SUM_REL of the tensor's largest, the norm of
    the difference over the tensor's norm, and the largest difference of
    the update; and the squared norms of all gradients and of their
    differences ("total")."""
    out, d2, g2 = {}, 0.0, 0.0
    for name, g_ref in ref["grads"].items():
        row = {}
        pairs = (("grad", got["grads"][name], g_ref),
                 ("update", got["after"][name] - got["before"][name],
                  ref["after"][name] - ref["before"][name]))
        for what, a, b in pairs:
            a, b = a.double(), b.double()
            d = (a - b).abs()
            row[f"{what}_off"] = (d > SEQ_INT8_SUM_REL * b.abs().max()).double().mean().item()
            row[f"{what}_rel"] = (d.norm() / b.norm().clamp_min(1e-30)).item()
            row[f"{what}_max"] = d.max().item()
            if what == "grad":
                d2 += d.square().sum().item()
                g2 += b.square().sum().item()
        out[name] = row
    out["total"] = {"diff_sq": d2, "grad_sq": g2}
    return out


def int8_seq_rank(group, device, argv, ref_path):
    """One rank of phase 26c: the driver's body (``cli.finetune.run_rank``)
    trains one int8 step with this rank's tokens on the one card. Returns
    its launches, its step-0 metrics, and its gradients and update held
    against one process's, saved at ref_path (seq_int8_held)."""
    import torch

    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    def counts():
        return kernel_counts(FA, TQ, DO)

    reset_kernel_counts(FA, TQ, DO)
    t = time.perf_counter()
    with step0_capture(torch, FT, counts) as rec:
        FT.run_rank(group, FT.get_args_parser().parse_args(argv), device)
    torch.cuda.synchronize()
    out = {"launches": counts(), "step": rec["launches"], "metrics": rec["metrics"],
           "s": time.perf_counter() - t}
    ref = torch.load(ref_path, map_location=device)
    out["held"] = seq_int8_held(torch, rec, ref)
    out["digest"] = [float(p.double().sum()) for p in rec["after"].values()]
    return out


def phase26_model(torch, FA, dev, tag, init):
    """(a), (b): the full-depth model of PHASE26_MODELS[tag] with the int8
    trunk on the state ``init``: evaluate() over its eval batches (launches,
    metrics finite), the logits against K6's plain version, 3 train steps
    (launches, every parameter finite and moved), one step against K6's and
    K7's plain versions (phase 4's bounds); the int8 forward and step beside
    the bf16 trunk's in turns, and their peak memory (information only).
    Returns the launches of each path."""
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )

    preset, bs, nb, bs_t = PHASE26_MODELS[tag]
    kw = dict(use_shared_rel_pos_bias=True, init_values=0.1)
    cfg = get_preset(preset, quant="int8", **kw)
    n_tok, depth, size = cfg.num_patches + 1, cfg.depth, cfg.img_size
    for m in (bs * n_tok, bs_t * n_tok):
        check(TQ.supported(m, cfg.embed_dim, 3 * cfg.embed_dim), f"{preset}'s trunk of {m} rows "
              "is not int8")
    stream = n_tok > 256
    attn_eval = {"K3": depth * nb} if stream else {"K1": depth * nb}
    attn_step = {"K3": depth, "K4": depth} if stream else {"K1": depth, "K2": depth}
    gen = torch.Generator(device=dev).manual_seed(26)
    qmm, wgrad = TQ.qmm, TQ.wgrad  # the counting wrappers, also inside quant_on_plain()

    def counts():
        return {**attention_counts(FA), **cross_counts(FA), "K6": qmm.launches,
                "K7": wgrad.launches, "K8": DO.fused_dropout.launches}

    none = {k: 0 for k in counts()}
    model = VisionTransformer(cfg, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(init)
    bf16_model = VisionTransformer(cfg.replace(quant="none"), dtype=torch.bfloat16, device=dev)
    bf16_model.load_state_dict(init)
    images = [torch.randint(0, 256, (bs, size, size, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]

    def batches():
        for u8, lbl in zip(images, labels):
            yield normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD), lbl

    launches = {}
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(FA, TQ, DO)
    metrics = evaluate(model, batches())
    torch.cuda.synchronize()
    key = f"{tag}_int8_evaluate"
    launches[key] = counts()
    peak_eval = torch.cuda.max_memory_allocated() / 2**30
    want = dict(none, K6=4 * depth * nb, **attn_eval)
    print(f"  ({tag}) {preset} int8, N={n_tok}: evaluate() over {nb} batches of {bs}: launches "
          f"{launches[key]}; {json.dumps(metrics)}", flush=True)
    check(launches[key] == want, f"{tag} int8 evaluate() launched {launches[key]}, expected {want}")
    check(all(math.isfinite(v) for v in metrics.values()), "non-finite metric")
    fwd, bf16_fwd = make_eval_forward(model), make_eval_forward(bf16_model)
    x0 = next(batches())[0]
    logits = fwd(x0)
    check(tuple(logits.shape) == (bs, cfg.num_classes) and torch.isfinite(logits).all().item(),
          f"{tag} int8 logits are not finite")
    with quant_on_plain(TQ):
        before = counts()
        ref = fwd(x0)
        check(counts()["K6"] == before["K6"], "the plain reference forward launched K6")
    diff, scale = (logits - ref).abs().max().item(), ref.abs().max().item()
    exact = bf16_fwd(x0)
    print(f"  logits K6 vs its plain version: max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio "
          f"{diff / scale:.3e} (bound {LOGIT_REL_BOUND}); int8 vs bf16 trunk on the same weights: "
          f"ratio {(logits - exact).abs().max().item() / exact.abs().max().item():.3e}",
          flush=True)
    check(diff <= LOGIT_REL_BOUND * scale, f"{tag} int8 logits disagree with K6's plain version's")
    _, runs = in_turns({"bf16": lambda: bf16_fwd(x0), "int8": lambda: fwd(x0)}, 3)
    print(f"  eval forward img/s at batch {bs} (information only): int8 "
          f"{[bs * 1000 / ms for ms in runs['int8']]}, bf16 trunk "
          f"{[bs * 1000 / ms for ms in runs['bf16']]}; peak memory of evaluate() {peak_eval:.2f} "
          "GiB", flush=True)
    del model, bf16_model, fwd, bf16_fwd, logits, ref, exact, images, x0

    # --- the finetune step (phase 9's: batch mixup, AdamW, layer decay 0.75)
    def build(**overrides):
        return large_512_model(torch, dev, init, train=True, preset=preset, quant="int8",
                               **overrides)

    x = torch.randn(bs_t, size, size, 3, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (bs_t,), generator=gen, device=dev)
    tmodel, state, step = build()
    n_steps = 3
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts(FA, TQ, DO)
    ms = [step(state, x, y, *large_512_gens(torch, dev, 11 + i)) for i in range(n_steps)]
    torch.cuda.synchronize()
    key = f"{tag}_int8_train_step"
    launches[key] = counts()
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    want = dict(none, K6=8 * depth * n_steps, K7=4 * depth * n_steps,
                **{k: v * n_steps for k, v in attn_step.items()})
    print(f"  {n_steps} steps at batch {bs_t}: launches {launches[key]}; " + "; ".join(
        f"loss {float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f}" for m in ms),
        flush=True)
    check(launches[key] == want, f"{tag} int8 steps launched {launches[key]}, expected {want}")
    check(all(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
              for m in ms), "non-finite loss or grad norm")
    moved = 0
    for k, v in tmodel.state_dict().items():
        check(torch.isfinite(v).all().item(), f"non-finite parameter {k}")
        moved += int(not torch.equal(v, init[k]))
    check(moved == len(init), f"only {moved} of {len(init)} parameter tensors changed")
    del tmodel
    # one step from the same weights and seeds on the kernels and on their
    # plain versions (the same rounding bits)
    _, st_k, step_k = build()
    reset_kernel_counts(FA, TQ, DO)
    m_k = step_k(st_k, x, y, *large_512_gens(torch, dev, 30))
    torch.cuda.synchronize()
    launches[f"{tag}_int8_train_step_held"] = counts()
    del st_k, step_k
    _, st_p, step_p = build()
    before = counts()
    with quant_on_plain(TQ):
        m_p = step_p(st_p, x, y, *large_512_gens(torch, dev, 30))
    torch.cuda.synchronize()
    check(counts()["K6"] == before["K6"] and counts()["K7"] == before["K7"],
          "the plain reference step launched K6 or K7")
    del st_p, step_p
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
    print(f"  one step, K6/K7 vs their plain versions: loss {loss_k:.6f} / {loss_p:.6f}, grad "
          f"norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
    check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
          f"the {tag} int8 step's loss disagrees with the plain versions'")
    check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
          f"the {tag} int8 step's grad norm disagrees with the plain versions'")
    # the int8 step beside the bf16 trunk's, in turns
    _, st_b, step_b = large_512_model(torch, dev, init, train=True, preset=preset)
    rates = {"int8": [], "bf16": []}
    for name in ("bf16", "int8", "int8", "bf16"):
        st, fn = (state, step) if name == "int8" else (st_b, step_b)
        g = large_512_gens(torch, dev, 20)
        rates[name].append(bs_t * 1000.0 / cuda_ms(lambda: fn(st, x, y, *g), 3))
    print(f"  train step img/s at batch {bs_t} (information only): int8 {rates['int8']}, bf16 "
          f"trunk {rates['bf16']}; peak memory of the {n_steps} int8 steps {peak_train:.2f} GiB",
          flush=True)
    return launches


def phase26_init(torch, dev, tag):
    """The weights of PHASE26_MODELS[tag]: ViT-L/16 512's carried from a 224
    model of the same width by resize_state_dict (phase 9's carry); ViT-H's
    drawn at 224. The rel-pos table at std 0.2, the head at 0.5."""
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.utils.checkpoint import resize_state_dict

    preset = PHASE26_MODELS[tag][0]
    kw = dict(use_shared_rel_pos_bias=True, init_values=0.1)
    gen = torch.Generator(device=dev).manual_seed(260)
    low_preset = "beit_large_patch16_224" if tag == "large" else preset
    low = VisionTransformer(get_preset(low_preset, **kw), dtype=torch.bfloat16, device=dev,
                            generator=gen)
    trunc_normal(0.2, 2.0)(low.rel_pos_bias.relative_position_bias_table, gen)
    trunc_normal(0.5, 2.0)(low.head.weight, gen)
    if low_preset == preset:
        return {k: v.detach().clone() for k, v in low.state_dict().items()}
    model = VisionTransformer(get_preset(preset, **kw), dtype=torch.bfloat16, device=dev)
    model.load_state_dict(resize_state_dict(low.state_dict(), model), strict=True)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase26_driver(torch, FA, dev, tmp, tag, pth, images, train_images=None):
    """(a), (b): cli.finetune --quant int8 at the preset of
    PHASE26_MODELS[tag] from ``pth`` over CIFAR-100 images: --eval (launches,
    the printed metrics against a CPU recomputation from the driver's own
    logits, those logits against K6's plain version's), and with
    ``train_images`` a 2-step epoch and its evaluation (launches per step).
    Returns the launches of each run."""
    import numpy as np

    from uncertainty_vit_tpu_torch.cli import builders as B
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
    from uncertainty_vit_tpu_torch.evals.collect import collect_logits
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    preset, bs, _, bs_t = PHASE26_MODELS[tag]
    size = 512 if tag == "large" else 224
    depth = {"large": 24, "huge": 32}[tag]
    n_tok = (size // 16) ** 2 + 1
    stream = n_tok > 256
    ev, tr = os.path.join(tmp, f"{tag}_eval"), os.path.join(tmp, f"{tag}_train")
    n_test = len(images)
    write_cifar100(ev, images, np.arange(n_test) % 100)

    def counts():
        return kernel_counts(FA, TQ, DO)

    def args_of(root, batch, *extra):
        return FT.get_args_parser().parse_args([
            "--model", preset, "--input_size", str(size), "--data_set", "CIFAR100",
            "--data_path", root, "--batch_size", str(batch), "--num_workers", "8",
            "--finetune", pth, "--output_dir", os.path.join(tmp, f"{tag}_out"), "--quant", "int8",
            *extra])

    def attn(n_fwd, n_bwd=0):
        return ({"K3": depth * n_fwd, "K4": depth * n_bwd} if stream
                else {"K1": depth * n_fwd, "K2": depth * n_bwd})

    args = args_of(ev, bs, "--eval")
    reset_kernel_counts(FA, TQ, DO)
    t0 = time.perf_counter()
    res = FT.main(args)["eval"]
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    paths = {f"cli16_{tag}_int8_eval": counts()}
    none = {k: 0 for k in counts()}
    n_fwd = -(-n_test // bs)
    want = dict(none, K6=4 * depth * n_fwd, **attn(n_fwd))
    print(f"  ({tag}) cli.finetune --model {preset} --input_size {size} --quant int8 --eval "
          f"({n_test} images at batch {bs}): launches {paths[f'cli16_{tag}_int8_eval']}; "
          f"{json.dumps(res)}; main() {eval_s:.2f} s with the model build and the .pth import",
          flush=True)
    check(paths[f"cli16_{tag}_int8_eval"] == want,
          f"the {tag} int8 --eval launched {paths[f'cli16_{tag}_int8_eval']}, expected {want}")
    model, _ = FT.build_model(args, 100, dev)
    FT.load_variables(args, model)
    loader, _ = B.build_loaders(args, is_train=False)
    fwd = make_eval_forward(model)
    logits, lab = collect_logits(fwd, FT._eval_batches(loader, args, dev))
    with quant_on_plain(TQ):
        ref, _ = collect_logits(fwd, FT._eval_batches(loader, args, dev))
    del model, fwd
    check(logits.shape == (n_test, 100) and np.isfinite(logits).all(), f"logits {logits.shape}")
    diff, scale = float(np.abs(logits - ref).max()), float(np.abs(ref).max())
    print(f"  --eval logits vs K6's plain version's on the same transformed images: "
          f"max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio {diff / scale:.3e} (bound "
          f"{LOGIT_REL_BOUND})", flush=True)
    check(diff <= LOGIT_REL_BOUND * scale, f"the driver's {tag} int8 logits disagree with K6's "
          "plain version's")
    on_cpu = {k: float(v) for k, v in M.classification_metrics(
        torch.from_numpy(logits), torch.from_numpy(lab)).items()}
    on_cpu["loss"] = on_cpu["nll"]
    check(sorted(res) == sorted(on_cpu), f"--eval metric keys {sorted(res)}")
    for k, v in on_cpu.items():
        check(abs(res[k] - v) <= METRIC_ATOL + METRIC_RTOL * abs(v),
              f"--eval printed {k} {res[k]}, recomputed on the CPU {v}")
    if train_images is None:
        return paths
    # --- one train epoch of 2 steps and its evaluation of the first 2 batches
    spe, n_eval_images = 2, 2 * bs_t
    write_cifar100(tr, train_images, np.arange(len(train_images)) % 100, "train")
    write_cifar100(tr, images[:n_eval_images], np.arange(n_eval_images) % 100)
    reset_kernel_counts(FA, TQ, DO)
    with watched_driver(torch, FT, counts) as rec:
        t0 = time.perf_counter()
        FT.main(args_of(tr, bs_t, "--epochs", "1", "--steps_per_epoch", str(spe),
                        "--no_save_ckpt", "--no_auto_resume", "--layer_decay", "0.75",
                        "--drop_path", "0.1"))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        rec.pop("model", None)
    key = f"cli16_{tag}_int8_train"
    paths[key] = counts()
    n_eval = n_eval_images // bs_t
    want = dict(none, K6=(8 * spe + 4 * n_eval) * depth, K7=4 * depth * spe,
                **attn(spe + n_eval, spe))
    print(f"  train epoch of {spe} steps at batch {bs_t} and its evaluation of {n_eval_images} "
          f"images: launches {paths[key]}; losses "
          + ", ".join(f"{float(r['metrics']['loss']):.5f}" for r in rec["steps"])
          + f"; main() {train_s:.2f} s", flush=True)
    check(paths[key] == want, f"the {tag} int8 epoch launched {paths[key]}, expected {want}")
    step_want = dict(none, K6=8 * depth, K7=4 * depth, **attn(1, 1))
    check(len(rec["steps"]) == spe and all(r["launches"] == step_want for r in rec["steps"]),
          f"the driver's int8 steps launched {[r['launches'] for r in rec['steps']]}")
    check(rec["steps"][1]["moved"], "the driver's int8 step 1 left the parameters")
    for r in rec["steps"]:
        for k in ("loss", "grad_norm"):
            check(math.isfinite(float(r["metrics"][k])), f"step {r['step']} {k}")
    gc.collect()  # the held optimizer sits in reference cycles
    return paths


def phase26_seq(torch, FA, dev, tmp):
    """(c) cli.finetune --quant int8 --seq_parallel 2 at ViT-B/16 384 (N =
    577, split 289 | 288; phase 18's flags without accumulation and masking)
    from phase 18's 224 .pth, two gloo ranks sharing the card, one step at
    --dtype float32 against the same step in one process: loss, gradient
    norm and the gradients at the bounds SEQ_INT8_* says, the ranks equal.
    Returns the launches of each run."""
    import numpy as np

    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.parallel import seq

    depth, bs = 12, 8
    rs = np.random.RandomState(18)
    root = os.path.join(tmp, "seq")
    write_cifar100(root, rs.randint(0, 256, (2 * bs, 32, 32, 3), dtype=np.uint8),
                   np.arange(2 * bs) % 100, "train")
    write_cifar100(root, rs.randint(0, 256, (bs, 32, 32, 3), dtype=np.uint8), np.arange(bs) % 100)
    pth = os.path.join(tmp, "vitb224_seq.pth")
    write_vitb_pth(torch, dev, get_preset("beit_base_patch16_224", num_classes=100,
                                          use_shared_rel_pos_bias=True, use_abs_pos_emb=False,
                                          init_values=0.1), pth, 180)

    def argv(out_dir, dtype, *extra):
        return ["--model", "beit_base_patch16_384", "--input_size", "384", "--data_set",
                "CIFAR100", "--data_path", root, "--num_workers", "8", "--finetune", pth,
                "--output_dir", os.path.join(tmp, out_dir), "--layer_decay", "0.65",
                "--drop_path", "0.1", "--warmup_epochs", "0", "--no_auto_resume",
                "--batch_size", str(bs), "--mixup", "0", "--cutmix", "0", "--quant", "int8",
                "--dtype", dtype, "--epochs", "1", "--steps_per_epoch", "1",
                "--disable_eval_during_finetuning", "--no_save_ckpt", *extra]

    def counts():
        return kernel_counts(FA, TQ, DO)

    none = {k: 0 for k in counts()}
    paths = {}
    # the one process's step 0, its gradients and update saved for the ranks
    reset_kernel_counts(FA, TQ, DO)
    with step0_capture(torch, FT, counts) as one:
        FT.main(FT.get_args_parser().parse_args(argv("one", "float32")))
    torch.cuda.synchronize()
    paths["cli16_int8_step_f32"] = counts()
    check(one["launches"] == dict(none, K3=depth, K4=depth, K6=8 * depth, K7=4 * depth),
          f"the one-process int8 step launched {one['launches']}")
    ref_path = os.path.join(tmp, "int8_step0.pt")
    torch.save({k: one[k] for k in ("grads", "before", "after")}, ref_path)
    one_metrics = one["metrics"]
    del one
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = seq.run_ranks(int8_seq_rank, 2, str(dev), argv("seq", "float32", "--seq_parallel", "2"),
                          ref_path, timeout=600.0)
    secs = time.perf_counter() - t0
    step_want = dict(none, K5=depth, K5_bwd=depth, K6=8 * depth, K7=4 * depth)
    for r, res in enumerate(ranks):
        held = res["held"]
        total = held.pop("total")
        rel = (total["diff_sq"] / total["grad_sq"]) ** 0.5
        worst = sorted(held, key=lambda k: -held[k]["grad_rel"])[:8]
        print(f"  (c) rank {r}: step launches {res['step']}; loss {res['metrics']['loss']:.7f}, "
              f"grad norm {res['metrics']['grad_norm']:.7f} (one process: "
              f"{one_metrics['loss']:.7f}, {one_metrics['grad_norm']:.7f}); all gradients' "
              f"difference over their norm {rel:.3e}; the worst tensors: "
              + "; ".join(f"{k} {json.dumps(held[k])}" for k in worst), flush=True)
        res["total_rel"] = rel
        check(res["step"] == step_want, f"rank {r}'s int8 step launched {res['step']}")
    a, b = ranks
    check(a["metrics"] == b["metrics"] and a["digest"] == b["digest"],
          "the two ranks' int8 steps differ")
    for k in ("loss", "grad_norm"):
        check(abs(a["metrics"][k] - one_metrics[k]) <= SEQ_INT8_SUM_REL * abs(one_metrics[k]),
              f"the two-rank int8 step's {k} disagrees with one process's")
    check(a["total_rel"] <= SEQ_INT8_TOTAL_REL, f"the two-rank int8 gradients differ from one "
          f"process's by {a['total_rel']:.3e} of their norm")
    worst = max(a["held"], key=lambda k: a["held"][k]["grad_rel"])
    check(a["held"][worst]["grad_rel"] <= SEQ_INT8_TENSOR_REL, f"the two-rank int8 gradient of "
          f"{worst} differs from one process's by {a['held'][worst]['grad_rel']:.3e} of its norm")
    paths["cli16_seq2_int8_step_f32"] = {k: a["launches"][k] + b["launches"][k]
                                         for k in a["launches"]}
    print(f"  (c) two ranks, f32: {secs:.1f} s from start to end (information only: the ranks "
          "share one card over gloo)", flush=True)
    return paths


def phase26_golden(torch, FA, dev, tmp):
    """(d) tools/torch_port_golden_eval.py on phase 16's .pth and images (the
    same seeds): its line equals the driver's --eval result in this run,
    printed as the reference prints it, and --expect of that triple passes
    while a loss 0.02 off exits 1."""
    import numpy as np

    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import torch_port_golden_eval as GE

    rs = np.random.RandomState(16)
    images = rs.randint(0, 256, (1024, 32, 32, 3), dtype=np.uint8)
    root = os.path.join(tmp, "golden")
    write_cifar100(root, images, np.arange(1024) % 100)
    cfg = get_preset("beit_base_patch16_224", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    pth = os.path.join(tmp, "golden_a.pth")
    write_vitb_pth(torch, dev, cfg, pth, 160)
    argv = ["--pth", pth, "--model", "beit_base_patch16_224", "--data_path", root,
            "--data_set", "CIFAR100", "--input_size", "224", "--batch_size", "128",
            "--num_workers", "8", "--output_dir", os.path.join(tmp, "golden_out")]
    a = GE.get_args_parser().parse_args(argv)
    direct = FT.main(FT.get_args_parser().parse_args(GE.build_cli_argv(a)))["eval"]
    reset_kernel_counts(FA, TQ, DO)
    out = GE.run(a)
    torch.cuda.synchronize()
    paths = {"cli16_golden_eval": kernel_counts(FA, TQ, DO)}
    line = (f"* Acc@1 {direct['acc1']:.3f} Acc@5 {direct['acc5']:.3f} "
            f"loss {direct['nll']:.3f}")
    print(f"  (d) tools/torch_port_golden_eval.py: {out['line']!r}; the driver's --eval in this "
          f"run: {line!r}; launches {paths['cli16_golden_eval']}", flush=True)
    check(out["line"] == line and (out["acc1"], out["acc5"], out["loss"]) == (
        float(direct["acc1"]), float(direct["acc5"]), float(direct["nll"])),
          "the golden tool's numbers differ from the driver's --eval")
    check(paths["cli16_golden_eval"]["K1"] == 12 * 8, f"the golden tool launched "
          f"{paths['cli16_golden_eval']}")
    triple = f"{out['acc1']:.3f},{out['acc5']:.3f},{out['loss']:.3f}"
    check(GE.main(argv + ["--expect", triple]) == 0, "--expect of the measured triple failed")
    off = f"{out['acc1']:.3f},{out['acc5']:.3f},{out['loss'] + 0.02:.3f}"
    check(GE.main(argv + ["--expect", off]) == 1, "--expect 0.02 off the loss passed")
    return paths


def phase26(torch, FA, dev):
    """Slice 16 on the card: the int8 trunk of ViT-L/16 512 (K3/K4 with
    K6/K7) and of ViT-H/16 224 (K1/K2 with K6/K7 at D = 80): their
    evaluate(), train steps and the finetune driver (a, b); the int8 step
    over two gloo ranks against one process (c); the golden-weights tool
    (d). Returns the launches of each path."""
    import tempfile

    import numpy as np

    bounded = FA.BOUNDED_SCORES
    FA.BOUNDED_SCORES = True  # as cli/finetune.py trains and evaluates
    paths = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rs = np.random.RandomState(26)
            for tag, (n_test, n_train) in (("large", (32, 0)), ("huge", (128, 64))):
                t0 = time.perf_counter()
                init = phase26_init(torch, dev, tag)
                paths.update(phase26_model(torch, FA, dev, tag, init))
                gc.collect()
                torch.cuda.empty_cache()
                # the driver's .pth: the same weights with a 100-class head,
                # ViT-L's at 224 (the driver's import carries it to 512)
                from uncertainty_vit_tpu_torch.core.config import get_preset
                low = "beit_large_patch16_224" if tag == "large" else PHASE26_MODELS[tag][0]
                pth = os.path.join(tmp, f"{tag}.pth")
                write_vitb_pth(torch, dev, get_preset(low, num_classes=100,
                                                      use_shared_rel_pos_bias=True,
                                                      use_abs_pos_emb=False, init_values=0.1),
                               pth, 261)
                del init
                images = rs.randint(0, 256, (n_test, 32, 32, 3), dtype=np.uint8)
                train = rs.randint(0, 256, (n_train, 32, 32, 3), dtype=np.uint8) if n_train \
                    else None
                paths.update(phase26_driver(torch, FA, dev, tmp, tag, pth, images, train))
                os.remove(pth)
                gc.collect()
                torch.cuda.empty_cache()
                print(f"  ({tag}) took {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            paths.update(phase26_seq(torch, FA, dev, tmp))
            print(f"  (c) took {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            paths.update(phase26_golden(torch, FA, dev, tmp))
            print(f"  (d) took {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        FA.BOUNDED_SCORES = bounded
    return paths


def phase27(torch, FA, dev, phase16_eval):
    """Slice 17: checkpoints written by the JAX package. (a) phase 16's
    ViT-B/16 224 .pth through the JAX layout and the converter, evaluated by
    the driver, against phase16_eval (its --eval metrics, its logits and
    their metrics on the CPU); (b)
    the committed golden of a JAX-written checkpoint; (c) the refusal where
    tensorstore is absent. Returns the launches of (a) and (b)."""
    import tempfile

    import numpy as np

    from uncertainty_vit_tpu_torch.cli import builders as B
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import make_eval_forward
    from uncertainty_vit_tpu_torch.evals.collect import collect_logits
    from uncertainty_vit_tpu_torch.models.vit import VisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.utils import checkpoint as C
    from uncertainty_vit_tpu_torch.utils import orbax as O

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tools"))
    import torch_port_orbax_to_pth as TOOL

    n_images, bs, depth = 1024, 128, 12
    rs = np.random.RandomState(16)
    images = rs.randint(0, 256, (n_images, 32, 32, 3), dtype=np.uint8)
    labels = np.arange(n_images) % 100
    cfg = get_preset("beit_base_patch16_224", num_classes=100, use_shared_rel_pos_bias=True,
                     use_abs_pos_emb=False, init_values=0.1)
    bounded = FA.BOUNDED_SCORES
    paths = {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            # --- (a) phase 16's weights through the JAX layout and the converter
            write_cifar100(tmp, images, labels)
            pth, converted = os.path.join(tmp, "a.pth"), os.path.join(tmp, "from_jax.pth")
            write_vitb_pth(torch, dev, cfg, pth, 160)
            sd = C.load_torch_state_dict(pth)
            variables = C.state_dict_to_flax(sd)
            check(list(variables) == ["params"], f"collections {list(variables)}")
            tree = {"params": variables["params"], "opt_state": [], "step": np.asarray(0),
                    "model_ema": None, "sngp_state": None, "spectral_stats": None,
                    "sngp_frozen": None}
            out = TOOL.write_pth(tree, converted, family="finetune")
            kept = [k for k in sd if "relative_position_index" not in k]
            check(sorted(out) == sorted(kept) and all(torch.equal(out[k], sd[k]) for k in kept),
                  "the converted .pth's tensors differ from the .pth's")
            argv = ["--model", "beit_base_patch16_224", "--input_size", "224", "--data_set",
                    "CIFAR100", "--data_path", tmp, "--batch_size", str(bs), "--num_workers",
                    "8", "--finetune", converted, "--output_dir", os.path.join(tmp, "out"),
                    "--eval"]
            args = FT.get_args_parser().parse_args(argv)
            reset_kernel_counts(FA, TQ, DO)
            res = FT.main(args)["eval"]
            torch.cuda.synchronize()
            paths["cli17_orbax_eval"] = kernel_counts(FA, TQ, DO)
            want = dict({k: 0 for k in paths["cli17_orbax_eval"]}, K1=depth * n_images // bs)
            print(f"  (a) --eval from the converted .pth: launches {paths['cli17_orbax_eval']}",
                  flush=True)
            check(paths["cli17_orbax_eval"] == want,
                  f"--eval launched {paths['cli17_orbax_eval']}, expected {want}")
            model, _ = FT.build_model(args, 100, dev)
            FT.load_variables(args, model)
            loader, _ = B.build_loaders(args, is_train=False)
            logits, lab = collect_logits(make_eval_forward(model),
                                         FT._eval_batches(loader, args, dev))
            check(np.array_equal(logits, phase16_eval["logits"]),
                  "the converted .pth's logits differ from phase 16's")
            # the metrics of those logits on the CPU are phase 16's to the bit;
            # the driver's, summed on the card, may part in their last bits
            # where a bin's sum is a scatter_add (atomics in any order)
            ref = phase16_eval["eval"]
            cpu = {k: float(v) for k, v in M.classification_metrics(
                torch.from_numpy(logits), torch.from_numpy(lab)).items()}
            check(cpu == phase16_eval["cpu"], "the CPU's metrics of the logits differ")
            parted = {k: abs(res[k] - ref[k]) for k in ref if res[k] != ref[k]}
            check(sorted(res) == sorted(ref) and all(
                abs(res[k] - v) <= METRIC_ATOL + METRIC_RTOL * abs(v) for k, v in ref.items()),
                f"--eval from the converted .pth {res} against phase 16's {ref}")
            print(f"  (a) {logits.shape} logits equal to phase 16's to the bit, and their "
                  f"metrics on the CPU; the driver's metrics equal to phase 16's but for "
                  f"{json.dumps(parted)} (rtol {METRIC_RTOL}, atol {METRIC_ATOL}: the card's "
                  f"scatter_add bins)", flush=True)
            del model, loader

            # --- (c) no tensorstore here: the reader and the driver refuse a directory
            jax_dir = os.path.join(tmp, "checkpoint-best")
            os.makedirs(jax_dir)
            with open(os.path.join(jax_dir, O.ORBAX_METADATA), "w") as f:
                json.dump({"tree_metadata": {"('step',)": {
                    "key_metadata": [{"key": "step", "key_type": 2}],
                    "value_metadata": {"value_type": "jax.Array", "skip_deserialize": False,
                                       "write_shape": []}}},
                    "use_ocdbt": True, "use_zarr3": False}, f)
            try:
                import tensorstore  # noqa: F401
                print("  (c) tensorstore is installed on this machine: the refusal does not "
                      "apply", flush=True)
            except ImportError:
                for what, call in (
                        ("read_orbax_tree", lambda: O.read_orbax_tree(jax_dir)),
                        ("--finetune DIR", lambda: FT.main(FT.get_args_parser().parse_args(
                            [jax_dir if a == converted else a for a in argv])))):
                    try:
                        call()
                        check(False, f"(c) {what} read a directory without tensorstore")
                    except RuntimeError as e:
                        check(O.CONVERTER in str(e), f"(c) {what} raised {e!r}")
                print(f"  (c) without tensorstore, read_orbax_tree and --finetune DIR raise "
                      f"naming {O.CONVERTER}", flush=True)

        # --- (b) the golden of a checkpoint the JAX package wrote
        golden = os.path.join(here, "tests", "golden_torch_port", "orbax_vit64")
        with open(os.path.join(golden, "meta.json")) as f:
            meta = json.load(f)
        gcfg = get_preset(meta["preset"], **meta["overrides"])
        model = VisionTransformer(gcfg, dtype=torch.bfloat16, device=dev)
        state, missing, unused = C.import_torch_state_dict(
            C.load_torch_state_dict(os.path.join(golden, "model.pth")), model.state_dict())
        check(not missing and not unused, f"golden import: missing {missing}, unused {unused}")
        model.load_state_dict(state, strict=True)
        grs = np.random.RandomState(meta["seeds"]["images"])
        x = grs.randint(0, 256, (meta["n_images"], 32, 32, 3)).astype(np.float32) / 255.0
        x = torch.from_numpy(((x - 0.5) / 0.5).astype(np.float32)).to(dev)
        FA.BOUNDED_SCORES = False  # the JAX model's exact softmax
        forward = make_eval_forward(model)
        reset_kernel_counts(FA, TQ, DO)
        got = forward(x).float().cpu().numpy()
        torch.cuda.synchronize()
        paths["cli17_golden"] = kernel_counts(FA, TQ, DO)
        want_logits = np.load(os.path.join(golden, "logits.npy"))
        scale = float(np.abs(want_logits).max())
        diff = float(np.abs(got - want_logits).max())
        top2 = np.sort(want_logits, axis=1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > LOGIT_REL_BOUND * scale
        print(f"  (b) golden {meta['preset']} {meta['overrides']} (JAX {meta['versions']}): "
              f"max|diff|={diff:.3e}, max|logit|={scale:.3e}, ratio {diff / scale:.3e} (bound "
              f"{LOGIT_REL_BOUND}); argmax equal on {int(clear.sum())} of {len(clear)} images "
              f"whose top two stand apart; launches {paths['cli17_golden']}", flush=True)
        check(diff <= LOGIT_REL_BOUND * scale, "the golden's logits disagree with JAX's")
        check(np.array_equal(got.argmax(1)[clear], want_logits.argmax(1)[clear]),
              "the golden's argmax differs from JAX's where the top two stand apart")
        gwant = dict({k: 0 for k in paths["cli17_golden"]}, K1=gcfg.depth)
        check(paths["cli17_golden"] == gwant,
              f"the golden forward launched {paths['cli17_golden']}, expected {gwant}")
    finally:
        FA.BOUNDED_SCORES = bounded
    return paths


# Phase 28: the finetune driver on the data x seq mesh (slice 18). The mesh
# is (data, seq, model); sizes: (train images, test images, batch per data
# rank, depth, MC samples). The train split's odd count pads the shards.
# ViT-B/16 384's widths (768, 12 heads, N = 577) at 4 of its blocks
# (--target_layer 3): the launch counts scale with the depth.
PHASE28_MESH = (2, 2, 1)
PHASE28_SIZES = (9, 8, 2, 4, 4)
# f32 runs that draw masks or noise, and the training's losses: the arrays
# read back within this of their largest value, each metric and loss within
# this of max(1, |one process's|)
PHASE28_F32_REL_BOUND = 1e-4
# the AdaHessian update's D = z * Hz on the seq pair against one process:
# max|diff| / max|D|; the pass with the old k/v gather backward must miss it
PHASE28_HESSIAN_REL_BOUND = 1e-3


def _old_gather_backward(ctx, grad):
    """The k/v gather's backward before this slice: an all-reduce in place on
    a clone, which a second backward cannot see through (phase 28d's
    mutation)."""
    import torch.distributed as dist

    total = grad.contiguous().clone()
    dist.all_reduce(total, group=ctx.group.group)
    start, stop = ctx.group.rows(ctx.n)
    return total[:, start:stop], None, None


@contextlib.contextmanager
def watched_mesh_driver(torch, np, FT):
    """Inside, each driver run's host reads (``evals.collect._finish``), its
    first K8 call's arguments, each train step's loss and gradient norm, and
    each optimizer step's Hessian estimate after the step (summed over the
    seq group there) are kept in rec; ``rec_reset`` empties it."""
    from uncertainty_vit_tpu_torch.evals import collect
    from uncertainty_vit_tpu_torch.models import layers as TL
    from uncertainty_vit_tpu_torch.train import optim as TO

    rec = {}

    def reset():
        rec.update(reads=[], k8=None, steps=[], hessians=[])

    reset()
    rec["reset"] = reset
    finish, dropout, make_step, opt_step = (collect._finish, TL.fused_dropout,
                                            FT.make_finetune_train_step, TO.ChainOptimizer.step)

    def recorded(pending):
        value = finish(pending)
        rec["reads"].append(np.array(value))
        return value

    def first_k8(x, rate, seed, window=None, fold=None):
        if rec["k8"] is None:
            rec["k8"] = (tuple(x.shape), rate, int(seed.item()), window, fold)
        return dropout(x, rate, seed, window, fold)

    def watched_make(*a, **k):
        step = make_step(*a, **k)

        def watched(*sa, **sk):
            m = step(*sa, **sk)
            rec["steps"].append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
            return m

        return watched

    def kept_hessian(self, lr, wd, hessian=None):
        norm = opt_step(self, lr, wd, hessian)
        if hessian is not None:
            rec["hessians"].append([h.detach().float().cpu().clone() for h in hessian])
        return norm

    collect._finish, TL.fused_dropout = recorded, first_k8
    FT.make_finetune_train_step, TO.ChainOptimizer.step = watched_make, kept_hessian
    try:
        yield rec
    finally:
        collect._finish, TL.fused_dropout = finish, dropout
        FT.make_finetune_train_step, TO.ChainOptimizer.step = make_step, opt_step


def k8_mask(torch, DO, dev, k8):
    """(kernel mask, plain mask) of a recorded K8 call: each applied to ones of
    the call's shape with its seed, window and fold (bool, on the CPU)."""
    shape, rate, seed, window, fold = k8
    ones = torch.ones(shape, device=dev)
    s = torch.tensor([seed], dtype=torch.int64, device=dev)
    got = DO.fused_dropout(ones, rate, s, window, fold)
    ref = DO.fused_dropout_plain(ones, rate, s, window, fold)
    return (got != 0).cpu(), (ref != 0).cpu()


def mesh_driver_rank(mesh, device, cases):
    """One rank of phase 28: each case's driver body (``cli.finetune.run_rank``)
    on the mesh, or with ``on_pair`` on its seq pair alone (a mesh of one data
    index, its output directory apart), with the k/v gather's old backward
    where ``mutated``. Returns {case: {"launches", "reads", "steps",
    "hessians", "k8" (the first K8 call: its arguments, and its mask on ones
    from the kernel, equal to the plain version's), "s" (host clock), "result"
    (rank 0's; None for a training run)}} and the rank's (data, seq) index."""
    import numpy as np
    import torch

    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
    from uncertainty_vit_tpu_torch.parallel import seq

    dev = torch.device(device)
    pair = meshlib.Mesh((1, mesh.size("seq"), 1), mesh.index("seq"),
                        (None, mesh.group("seq"), None), mesh.group("seq"))
    out = {}
    with watched_mesh_driver(torch, np, FT) as rec:
        for name, argv, trains, on_pair, mutated in cases:
            argv = list(argv)
            if on_pair:
                argv[argv.index("--output_dir") + 1] += f"_pair{mesh.index('data')}"
            rec["reset"]()
            backward = seq._GatherTokens.backward
            if mutated:
                seq._GatherTokens.backward = staticmethod(_old_gather_backward)
            torch.cuda.synchronize()
            reset_kernel_counts(FA, TQ, DO)
            t = time.perf_counter()
            try:
                res = FT.run_rank(pair if on_pair else mesh, FT.get_args_parser().parse_args(argv),
                                  device)
                torch.cuda.synchronize()
            finally:
                seq._GatherTokens.backward = backward
            run = {"launches": kernel_counts(FA, TQ, DO), "s": time.perf_counter() - t,
                   "reads": rec["reads"], "steps": rec["steps"], "hessians": rec["hessians"],
                   "result": None if trains else res, "k8": None}
            if rec["k8"] is not None:
                got, ref = k8_mask(torch, DO, dev, rec["k8"])
                check(torch.equal(got, ref), f"28 {name}: K8's mask through the fold differs "
                                             "from its plain version's")
                run["k8"] = (rec["k8"], got)
            out[name] = run
            del res
            gc.collect()
    return out, (mesh.index("data"), mesh.index("seq"))


def _held(got: float, want: float, rel: float) -> bool:
    return math.isfinite(got) and abs(got - want) <= rel * max(1.0, abs(want))


def phase28(torch, FA, dev):
    """Slice 18 on the card: ``cli.finetune`` on a data 2 x seq 2 mesh of four
    gloo ranks sharing the card (``main(args, mesh=(2, 2, 1))``'s layout, one
    ``run_ranks`` call for every sub-phase), at ViT-B/16 384's widths from a
    seeded ViT-B/16 224 .pth with a 100-class head, over seeded 32x32
    CIFAR-100 images; each run then in one process given the global batch
    (``BatchLoader(hosts_per_batch=2)`` reads the two data ranks' padded
    shards as global batches). 28a: --eval in bf16, MC-dropout folded and
    split, and the het head (f32); 28b: two epochs of training in f32 (the
    odd train split padded; each epoch evaluated over the union of the
    shards); 28c: --sinkformer, an epoch of one step (f32) and --eval (bf16);
    28d: --opt adahessian on each seq pair (f32), and again with the k/v
    gather's old backward. Returns the launches of each path, summed over
    the ranks ("cli18_mesh_") and in one process ("cli18_one_")."""
    import functools
    import tempfile

    import numpy as np

    from uncertainty_vit_tpu_torch.cli import builders as TB
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.data.pipeline import BatchLoader
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import philox
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.parallel import seq

    t_phase = time.perf_counter()
    n_train, n_test, b, depth, k = PHASE28_SIZES
    data, s_size, _ = PHASE28_MESH
    split = depth // 2
    fwd = -(-n_test // (data * b))  # eval batches a rank
    steps = -(-n_train // data) // b  # train steps a rank and epoch (padded, tail dropped)
    rs = np.random.RandomState(28)
    want0 = {k_: 0 for k_ in kernel_counts(FA, TQ, DO)}
    paths = {}
    bounded = FA.BOUNDED_SCORES
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_cifar100(tmp, rs.randint(0, 256, (n_train, 32, 32, 3), dtype=np.uint8),
                           np.arange(n_train) % 100, "train")
            write_cifar100(tmp, rs.randint(0, 256, (n_test, 32, 32, 3), dtype=np.uint8),
                           np.arange(n_test) % 100, "test")
            pth = os.path.join(tmp, "vitb224.pth")
            write_vitb_pth(torch, dev, get_preset(
                "beit_base_patch16_224", num_classes=100, use_shared_rel_pos_bias=True,
                use_abs_pos_emb=False, init_values=0.1, depth=depth), pth, 280)

            def argv(name, batch, *extra, train=False, dtype="float32"):
                return ["--model", "beit_base_patch16_384", "--input_size", "384",
                        "--target_layer", str(depth - 1), "--data_set", "CIFAR100",
                        "--data_path", tmp, "--num_workers", "4", "--batch_size", str(batch),
                        "--finetune", pth, "--output_dir", os.path.join(tmp, name),
                        "--dtype", dtype, "--no_auto_resume",
                        *([] if train else ["--eval"]), *extra,
                        "--seq_parallel", str(s_size)]

            mc = ["--mc_dropout", "--mc_dropout_forwards", str(k), "--drop", "0.1"]
            epoch = ["--warmup_epochs", "1", "--layer_decay", "0.65", "--save_ckpt_freq", "1"]
            one_step = ["--epochs", "1", "--steps_per_epoch", "1",
                        "--disable_eval_during_finetuning", "--no_save_ckpt"]
            # name → (extra flags, trains, on a seq pair, mutated, dtype, the launches of a
            # rank: K5 a forward and K5_bwd a backward a block, K8 two a block that drops)
            cases = {
                "eval": ([], False, False, False, "bfloat16", dict(K5=depth * fwd)),
                "mc_folded": (mc, False, False, False, "float32",
                              dict(K5=depth * fwd, K8=2 * depth * fwd)),
                "mc_split": (mc + ["--mc_dropout_split_at", str(split), "--dropout_from_block",
                                   str(split)], False, False, False, "float32",
                             dict(K5=depth * fwd, K8=2 * (depth - split) * fwd)),
                "het": (["--het_layer"], False, False, False, "float32", dict(K5=depth * fwd)),
                "train": (["--epochs", "2", *epoch], True, False, False, "float32",
                          dict(K5=depth * 2 * (steps + fwd), K5_bwd=depth * 2 * steps)),
                "sinkformer_train": (["--sinkformer", *epoch, *one_step], True, False, False,
                                     "float32", {}),
                "sinkformer_eval": (["--sinkformer"], False, False, False, "bfloat16", {}),
                "adahessian": (["--opt", "adahessian", "--lr", "1e-3", *epoch, *one_step], True,
                               True, False, "float32", dict(K5=depth, K5_bwd=depth)),
                "adahessian_old_gather": (["--opt", "adahessian", "--lr", "1e-3", *epoch,
                                           *one_step], True, True, True, "float32",
                                          dict(K5=depth, K5_bwd=depth)),
            }

            def case_argv(name, batch, s=s_size):
                extra, trains, _, _, dtype, _ = cases[name]
                a = argv(name, batch, *extra, train=trains, dtype=dtype)
                return a[:-1] + [str(s)]

            rank_cases = [(name, case_argv(name, b), c[1], c[2], c[3])
                          for name, c in cases.items()]

            # --- the four ranks
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = seq.run_ranks(mesh_driver_rank, data * s_size, str(dev), rank_cases,
                                  timeout=900.0, mesh=PHASE28_MESH)
            ranks_s = time.perf_counter() - t0
            for r, (res, _) in enumerate(ranks):
                for name, run in res.items():
                    exp = dict(want0, **cases[name][5])
                    check(run["launches"] == exp,
                          f"28 rank {r} {name} launched {run['launches']}, expected {exp}")
                    check((run["result"] is None) == (r != 0 or cases[name][1]),
                          f"28 rank {r} {name} returned {type(run['result'])}")
            for name in cases:
                paths[f"cli18_mesh_{name}"] = {
                    k_: sum(res[name]["launches"][k_] for res, _ in ranks) for k_ in want0}
            print(f"  28 four ranks as mesh {PHASE28_MESH} ({card_line()}), launches a rank: "
                  + "; ".join(f"{n}: {run['launches']}" for n, run in ranks[0][0].items()),
                  flush=True)
            print("  28 seconds a run on rank 0 (host clock, model build and .pth import "
                  "included): " + ", ".join(f"{n} {run['s']:.2f}" for n, run in
                                            ranks[0][0].items())
                  + f"; the ranks ran {ranks_s:.1f} s from start to end", flush=True)
            for res, _ in ranks:
                n_steps = [len(res[name]["steps"]) for name in ("train",)]
                check(n_steps == [2 * steps], f"28b a rank took {n_steps} steps, expected "
                                             f"{2 * steps}: the padded shards hold every rank "
                                             "to the same steps")

            # --- one process given the global batch (the seq pair's cases: batch b)
            one = {}
            global_batches = functools.partial(BatchLoader, hosts_per_batch=data)
            loader = TB.BatchLoader
            with watched_mesh_driver(torch, np, FT) as rec:
                for name, c in cases.items():
                    on_pair = c[2]
                    if c[3]:  # the mutation runs on the ranks alone
                        continue
                    rec["reset"]()
                    a1 = case_argv(name, b if on_pair else data * b, s=1)
                    a1[a1.index("--output_dir") + 1] += "_one"
                    reset_kernel_counts(FA, TQ, DO)
                    t = time.perf_counter()
                    TB.BatchLoader = loader if on_pair else global_batches
                    try:
                        res = FT.main(FT.get_args_parser().parse_args(a1))
                        torch.cuda.synchronize()
                    finally:
                        TB.BatchLoader = loader
                    one[name] = {"launches": kernel_counts(FA, TQ, DO),
                                 "s": time.perf_counter() - t, "reads": rec["reads"],
                                 "steps": rec["steps"], "hessians": rec["hessians"],
                                 "result": None if c[1] else res,
                                 "k8": None if rec["k8"] is None
                                 else (rec["k8"], k8_mask(torch, DO, dev, rec["k8"])[0])}
                    del res
                    gc.collect()
                    torch.cuda.empty_cache()
            for name, run in one.items():
                n = cases[name][5]
                factor = 1 if cases[name][2] else data  # the pair's cases: batch b
                # one process runs K3 / K4 (N = 577) where a rank runs K5; a rank's
                # forwards are one process's
                exp = dict(want0, K3=n.get("K5", 0), K4=n.get("K5_bwd", 0), K8=n.get("K8", 0))
                check(run["launches"] == exp, f"28 one process {name} launched "
                                              f"{run['launches']}, expected {exp} (batch "
                                              f"{factor * b})")
                paths[f"cli18_one_{name}"] = run["launches"]

            # --- the holds
            worst = {}
            for name in ("eval", "mc_folded", "mc_split", "het", "sinkformer_eval"):
                bound_ = LOGIT_REL_BOUND if cases[name][4] == "bfloat16" else PHASE28_F32_REL_BOUND
                ref = one[name]["reads"]
                rel = 0.0
                for res, (d, _) in ranks:
                    got = res[name]["reads"]
                    check(len(got) == len(ref) > 0, f"28 {name}: {len(got)} reads on a rank, "
                                                    f"{len(ref)} in one process")
                    for g, w in zip(got, ref):
                        # rank d holds rows [d·b', (d + 1)·b') of each global batch of D·b'
                        part = w[d * len(g):(d + 1) * len(g)]
                        check(g.shape == part.shape, f"28 {name}: shapes {g.shape} / {part.shape}")
                        if np.issubdtype(w.dtype, np.floating):
                            rel = max(rel, float(np.abs(g - part).max())
                                      / max(float(np.abs(w).max()), 1e-30))
                        else:
                            check(np.array_equal(g, part), f"28 {name}: the labels differ")
                worst[name] = rel
                check(rel <= bound_, f"28 {name}: the ranks' arrays differ from one process's "
                                     f"rows by {rel:.3e} of their largest value (bound {bound_})")
                got, ref_res = ranks[0][0][name]["result"], one[name]["result"]
                check(list(got) == list(ref_res), f"28 {name}: result keys {list(got)}")
                for key, metrics in ref_res.items():
                    for m, v in metrics.items():
                        g = got[key][m]
                        if m in ("acc1", "acc5"):
                            ok = abs(g - v) * n_test / 100 <= (1 if bound_ > 1e-3 else 0) + 1e-6
                        else:
                            ok = _held(g, v, bound_)
                        check(ok, f"28 {name}: {m} {g} on the mesh, {v} in one process")
            # the MC masks: the first K8 call of each rank against its plain
            # version (in the rank) and against one process's rows, to the bit
            for name in ("mc_folded", "mc_split"):
                (shape1, _, seed1, window1, fold1), mask1 = one[name]["k8"]
                check(window1 is None and fold1 is None, f"28 {name}: one process's K8 call")
                for res, (d, q) in ranks:
                    (shape, _, seed, window, fold), mask = res[name]["k8"]
                    check(seed == seed1, f"28 {name}: rank ({d}, {q}) drew seed {seed}, one "
                                         f"process {seed1}")
                    start, nn = window
                    rows = philox.fold_images(shape[0], fold)
                    want_mask = mask1.reshape(shape1[0], nn, -1)[rows, start:start + shape[1]]
                    check(torch.equal(mask.reshape(want_mask.shape), want_mask),
                          f"28 {name}: rank ({d}, {q})'s K8 mask through the fold {fold} and "
                          f"window {window} is not one process's rows")
            # 28b / 28c / 28d: losses and gradient norms step by step
            for name in ("train", "sinkformer_train", "adahessian"):
                for res, _ in ranks:
                    got, ref = res[name]["steps"], one[name]["steps"]
                    check(len(got) == len(ref) > 0, f"28 {name}: {len(got)} / {len(ref)} steps")
                    for i, (g, w) in enumerate(zip(got, ref)):
                        for key in ("loss", "grad_norm"):
                            check(_held(g[key], w[key], PHASE28_F32_REL_BOUND),
                                  f"28 {name} step {i}: {key} {g[key]} on the mesh, "
                                  f"{w[key]} in one process")
            epochs = {}
            for tag in ("train", "train_one"):
                with open(os.path.join(tmp, tag, "log.txt")) as f:
                    epochs[tag] = [json.loads(line) for line in f]
            check(len(epochs["train"]) == len(epochs["train_one"]) == 2, "28b's log.txt")
            for e, (g, w) in enumerate(zip(epochs["train"], epochs["train_one"])):
                check(_held(g["train_loss"], w["train_loss"], PHASE28_F32_REL_BOUND),
                      f"28b epoch {e}: loss {g['train_loss']} on the mesh, {w['train_loss']} "
                      "in one process")
            hz = {}
            for name in ("adahessian", "adahessian_old_gather"):
                rel = 0.0
                ref = one["adahessian"]["hessians"]
                for res, _ in ranks:
                    got = res[name]["hessians"]
                    check(len(got) == len(ref) == 1, f"28 {name}: Hessian estimates")
                    top = max(float(w.abs().max()) for w in ref[0])
                    rel = max(rel, max(float((g - w).abs().max()) for g, w in zip(got[0], ref[0]))
                              / top)
                hz[name] = rel
            check(hz["adahessian"] <= PHASE28_HESSIAN_REL_BOUND,
                  f"28d: D on the seq pair differs from one process's by {hz['adahessian']:.3e} "
                  f"of max|D| (bound {PHASE28_HESSIAN_REL_BOUND})")
            check(hz["adahessian_old_gather"] > PHASE28_HESSIAN_REL_BOUND,
                  f"28d: with the old gather backward D differs by only "
                  f"{hz['adahessian_old_gather']:.3e}: the hold would not see it")
            print("  28 the ranks against one process, max|diff| / max|value| of the arrays "
                  f"read back (bound {LOGIT_REL_BOUND} in bf16, {PHASE28_F32_REL_BOUND} in "
                  "f32): " + ", ".join(f"{n} {v:.3e}" for n, v in worst.items())
                  + "; K8's masks through the fold equal to the bit to the plain version's and "
                  "one process's rows; 28b epochs' losses "
                  + ", ".join(f"{g['train_loss']:.6f} / {w['train_loss']:.6f}"
                              for g, w in zip(epochs["train"], epochs["train_one"]))
                  + f"; 28c step 0 loss {ranks[0][0]['sinkformer_train']['steps'][0]['loss']:.6f}"
                  f" / {one['sinkformer_train']['steps'][0]['loss']:.6f}; 28d max|dD| / max|D| "
                  f"{hz['adahessian']:.3e} (bound {PHASE28_HESSIAN_REL_BOUND}), with the old "
                  f"gather backward {hz['adahessian_old_gather']:.3e}", flush=True)
            print("  28 launches a path (K5 forward / backward, K8), summed over the ranks: "
                  + "; ".join(f"{p}: K5 {n['K5']} / {n['K5_bwd']}, K8 {n['K8']}"
                              for p, n in paths.items() if p.startswith("cli18_mesh_"))
                  + f"; one process's seconds a run: "
                  + ", ".join(f"{n} {r['s']:.2f}" for n, r in one.items()), flush=True)
    finally:
        FA.BOUNDED_SCORES = bounded
    print(f"  28 (information only; {card_line()}; four ranks sharing one card through host "
          f"memory, not a multi-card rate): the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths


# Phase 29: the finetune driver's data axis with nothing refused (slice 19).
# The mesh is (data, seq, model); sizes: (train images, test images, batch
# per data rank, depth, MC samples); ViT-B/16 at 224 and 384 at 4 of its 12
# blocks (--target_layer 3).
PHASE29_MESH = (2, 2, 1)
PHASE29_SIZES = (9, 8, 2, 4, 4)
PHASE29_ATTN_DROP = 0.05
# 29a: the int8 step 0's gradients on the mesh against one process's (norm
# of the difference over the norm, f32). The last bits of the group's f32
# sums flip a few stochastic rounding decisions, and the flips reach the
# earlier layers through the backward: all tensors together read 2.85e-5,
# the last block's int8 weights at most 5.2e-6 (phase 26c, the seq window
# alone at twelve blocks, 1.09e-4 in all). With image0 = 0 on every data
# rank (the mutation, which must miss both bounds) a data rank's rows
# re-round: 2.49e-4 in all, 1.52e-3 in the last block (H100 80GB HBM3,
# 700.00 W).
PHASE29_INT8_TOTAL_REL, PHASE29_INT8_LAST_REL = 1e-4, 1e-4
# 29a: the int8 layer probe at ViT-B/16 384's qkv (4 images of 577 tokens,
# K = 768, N = 2304) on each rank's rows of the global trunk
PHASE29_PROBE = (4, 577, 768, 2304)


@contextlib.contextmanager
def first_attention_dropout(FA, rec):
    """Inside, the first K1 / K3 call that drops (its qkv shape and dtype,
    heads, seed, rate and batch fold) is kept in rec["attn"]."""
    forward = FA._forward

    def watched(qkv, bias, qv_bias, scale, h, bounded, want_lse, seed, rate, fold=None):
        if rate > 0.0 and rec.get("attn") is None:
            rec["attn"] = (tuple(qkv.shape), qkv.dtype, h, int(seed.item()), rate, fold)
        return forward(qkv, bias, qv_bias, scale, h, bounded, want_lse, seed, rate, fold)

    FA._forward = watched
    try:
        yield rec
    finally:
        FA._forward = forward


def attention_masks(torch, FA, call, dev):
    """(kernel mask, plain mask), bool [B, H, N, N] on the CPU, of a recorded
    K1 / K3 call (``first_attention_dropout``): with q = k = 0 every
    probability is 1/N, and v one-hot on 64 keys at a time (each head's 64
    columns) reads each key's keep bit off the kernel's output, exactly;
    the plain mask is philox's bits of the same seed and fold."""
    from uncertainty_vit_tpu_torch.ops import philox as P

    (b, n, c3), dtype, h, seed, rate, fold = call
    c = c3 // 3
    d = c // h
    s = torch.tensor([seed], dtype=torch.int64, device=dev)
    got = torch.empty(b, h, n, n, dtype=torch.bool)
    with torch.no_grad():
        for k0 in range(0, n, d):
            keys = torch.arange(k0, min(k0 + d, n), device=dev)
            qkv = torch.zeros(b, n, c3, dtype=dtype, device=dev)
            qkv[..., 2 * c:].view(b, n, h, d)[:, keys, :, keys - k0] = 1.0
            out = FA.fused_qkv_attention(qkv, None, None, s, 1.0, h, rate, fold=fold)
            got[..., k0:k0 + len(keys)] = (out.view(b, n, h, d)[..., :len(keys)] != 0
                                           ).permute(0, 2, 1, 3).cpu()
    bits = P.attention_bits(s, b, h, n, n, fold=fold)
    return got, (bits >= P.threshold(rate)).cpu()


def int8_probe(torch, dev, mesh=None, image0_zero=False):
    """The int8 layer's pieces on a rank's rows of PHASE29_PROBE's global
    trunk (the data rank's images, the seq rank's tokens; one process: all):
    K6's stochastic dgrad and K7's int32 sums through the row window, the
    wgrad column scales over the data x seq ranks, each kernel against its
    plain version to the bit. Returns (dgrad, sums) on the CPU."""
    from uncertainty_vit_tpu_torch.ops import quant as TQ

    images, n, k, m_out = PHASE29_PROBE
    gen = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn(images, n, k, generator=gen, device=dev)
    g = torch.randn(images, n, m_out, generator=gen, device=dev) * 0.01
    w = torch.randn(m_out, k, generator=gen, device=dev) * 0.05
    seed = torch.tensor([0x1929], dtype=torch.int64, device=dev)
    window = group = None
    if mesh is not None:
        b = images // mesh.size("data")
        d = mesh.index("data")
        shard = mesh.seq_group.shard(n) if mesh.seq_group is not None else None
        start, stop = (0, n) if shard is None else (shard.start, shard.stop)
        x, g = x[d * b:(d + 1) * b, start:stop], g[d * b:(d + 1) * b, start:stop]
        window, group = (stop - start, start, n, 0 if image0_zero else d * b), mesh.trunk_group
    x2, g2 = x.reshape(-1, k).contiguous(), g.reshape(-1, m_out).contiguous()
    sx, sg = TQ.wgrad_scales(x2, g2, group)
    acc = TQ.wgrad_acc(x2, g2, sx.reciprocal(), sg.reciprocal(), seed, window)
    acc_plain = TQ.wgrad_acc_plain(x2, g2, sx.reciprocal(), sg.reciprocal(), seed, window)
    check(torch.equal(acc, acc_plain), f"29a K7 through the window {window} differs from its "
                                       "plain version")
    wtq, wts = TQ.quantize_cols(w)
    dx = TQ.qmm(g2, wtq, wts, None, seed, True, torch.float32, window)
    check(torch.equal(dx, TQ.qmm_plain(g2, wtq, wts, None, seed, True, torch.float32, window)),
          f"29a K6's dgrad through the window {window} differs from its plain version")
    return dx.reshape(x.shape[0], x.shape[1], k).cpu(), acc.cpu()


@contextlib.contextmanager
def phase29_mutation(name):
    """The mutations that phase 29's holds must see: "image0_zero", every
    int8 layer's rounding bits drawn as if its images began the global
    batch; "hz_unsummed", each rank's share of D left unsummed over the data
    group."""
    from uncertainty_vit_tpu_torch.models import layers as TL
    from uncertainty_vit_tpu_torch.parallel import mesh as meshlib
    from uncertainty_vit_tpu_torch.train import optim as TO

    if name is None:
        yield
        return
    if name == "image0_zero":
        real = TL.quant_ops.int8_dense
        TL.quant_ops.int8_dense = lambda *a, image0=0, **k: real(*a, image0=0, **k)
        try:
            yield
        finally:
            TL.quant_ops.int8_dense = real
        return
    real_est, real_sum = TO.hutchinson_hessian_diag, meshlib.GradReducer.sum_data
    mine = []

    def est(*a, **k):
        mine.append(real_est(*a, **k))
        return mine[-1]

    def sum_data(self, tensors):
        if not any(tensors is d for d in mine):
            real_sum(self, tensors)

    TO.hutchinson_hessian_diag, meshlib.GradReducer.sum_data = est, sum_data
    try:
        yield
    finally:
        TO.hutchinson_hessian_diag, meshlib.GradReducer.sum_data = real_est, real_sum


def int8_grad_stats(torch, got, ref, depth) -> dict:
    """Step 0's gradients ``got`` against one process's ``ref`` (by name, on
    the CPU): the norm of the difference over the norm of all tensors
    ("total"), the largest of that ratio over the tensors ("worst", its
    name), and over the last block's four int8 weights ("last": the fewest
    flips reach it from the layers after it)."""
    d2 = n2 = 0.0
    rel = {}
    for name, v in ref.items():
        d = (got[name].double() - v.double()).norm().item()
        n_ = v.double().norm().item()
        d2, n2 = d2 + d * d, n2 + n_ * n_
        rel[name] = d / max(n_, 1e-30)
    last = [f"blocks.{depth - 1}.{w}.weight" for w in ("attn.qkv", "attn.proj", "mlp.fc1",
                                                        "mlp.fc2")]
    worst = max(rel, key=rel.get)
    return {"total": (d2 / n2) ** 0.5, "worst": rel[worst], "worst_name": worst,
            "last": max(rel[n_] for n_ in last)}


def phase29_run(torch, np, FT, FA, TQ, DO, dev, argv, mesh=None, ref=None):
    """One driver run of phase 29 (``run_rank`` on ``mesh``; ``main`` in one
    process): {"launches", "s", "reads", "steps", "hessians", "k8", "attn",
    "step0", "result"}; the first K8 and K1 / K3 dropout masks probed
    against their plain versions here. With ``ref`` (one process's "step0"
    gradients and "hessian", loaded from a file) step 0's gradients and the
    Hessian estimate are held against it here ("int8": int8_grad_stats,
    "hz": max|dD| / max|D|) and not returned."""
    torch.cuda.synchronize()
    reset_kernel_counts(FA, TQ, DO)
    t = time.perf_counter()
    with watched_mesh_driver(torch, np, FT) as rec, first_attention_dropout(FA, rec), \
            step0_capture(torch, FT, lambda: kernel_counts(FA, TQ, DO)) as cap:
        rec["attn"] = None
        args = FT.get_args_parser().parse_args(argv)
        res = FT.run_rank(mesh, args, str(dev)) if mesh is not None else FT.main(args)
        torch.cuda.synchronize()
        run = {"launches": kernel_counts(FA, TQ, DO), "s": time.perf_counter() - t,
               "reads": rec["reads"], "steps": rec["steps"], "hessians": rec["hessians"],
               "result": None if not args.eval else res, "k8": None, "attn": None,
               "step0": {k: {n: v.cpu() for n, v in cap[k].items()} for k in ("grads",)}
               if "grads" in cap else None}
        if rec["k8"] is not None:
            got, plain = k8_mask(torch, DO, dev, rec["k8"])
            check(torch.equal(got, plain), f"29 {argv}: K8's mask through the fold differs from "
                                           "its plain version's")
            run["k8"] = (rec["k8"], got)
        if rec["attn"] is not None:
            got, plain = attention_masks(torch, FA, rec["attn"], dev)
            check(torch.equal(got, plain), f"29: the attention kernel's mask of {rec['attn']} "
                                           "differs from its plain version's")
            run["attn"] = (rec["attn"], np.packbits(got.numpy()), tuple(got.shape))
    if ref is not None and run["step0"] is not None and "grads" in ref:
        depth = int(args.target_layer) + 1
        run["int8"] = int8_grad_stats(torch, run["step0"]["grads"], ref["grads"], depth)
    if mesh is not None:  # a rank returns none of its gradients
        run["step0"] = None
    if ref is not None and run["hessians"] and "hessian" in ref:
        got, want = run["hessians"], ref["hessian"]
        top = max(float(w.abs().max()) for w in want)
        run["hz"] = max(float((g.cpu() - w).abs().max()) for g, w in zip(got[0], want)) / top
        run["hessians"] = len(got)
    del res
    gc.collect()
    return run


def data_axis_rank(mesh, device, cases, refs):
    """One rank of phase 29: each case's driver body on the mesh or on its
    data pair (a (2, 1, 1) mesh of this rank's seq index, its output
    directory apart), under its mutation, held against one process's
    saved step 0 (``refs``: case → file) where given; and 29a's int8 layer
    probe. Returns ({case: phase29_run's record}, the probe, (data, seq))."""
    import numpy as np
    import torch

    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.parallel import mesh as meshlib

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    data_group = mesh.group(meshlib.DATA_AXIS)
    pair = meshlib.Mesh((mesh.size("data"), 1, 1), mesh.index("data"), (data_group, None, None),
                        data_group)
    out = {}
    for name, argv, layout, mutation in cases:
        argv = list(argv)
        if layout == "pair":
            argv[argv.index("--output_dir") + 1] += f"_pair{mesh.index('seq')}"
        ref = torch.load(refs[name]) if name in refs else None
        with phase29_mutation(mutation):
            out[name] = phase29_run(torch, np, FT, FA, TQ, DO, dev, argv,
                                    pair if layout == "pair" else mesh, ref)
        del ref
    probe = int8_probe(torch, dev, mesh)
    return out, probe, (mesh.index("data"), mesh.index("seq"))


def phase29(torch, FA, dev):
    """Slice 19 on the card: ``cli.finetune`` on the data axis with nothing
    refused, four gloo ranks sharing the card as the mesh (2, 2, 1) in one
    ``run_ranks`` call, each case on the mesh or on each seq index's data
    pair (2, 1, 1), at ViT-B/16's widths and 4 blocks from seeded .pth files
    over seeded 32x32 CIFAR-100 images; each run then in one process given
    the global batch (``BatchLoader(hosts_per_batch=2)``). 29a --quant int8
    --seq_parallel 2 at 384 (f32): two epochs, step 0's gradients, the same
    step with image0 = 0, --eval (bf16), and the layer probe; 29b
    --attn_drop_rate 0.05 on the pairs: two steps at 224, one at 384 (f32),
    --eval --mc_dropout folded and split at 224 (f32); the kernels' masks
    through the fold; 29c --opt adahessian on (2, 2, 1) (f32), and with Hz
    unsummed over the data group; 29d --stochastic on the pairs at 224:
    two epochs and --eval (f32). Then K1 with dropout and K6's dgrad timed
    flat and through a fold / an image offset. Returns the launches of each
    path, summed over the ranks ("cli19_mesh_") and in one process
    ("cli19_one_"), and the two timings."""
    import functools
    import tempfile

    import numpy as np

    from uncertainty_vit_tpu_torch.cli import builders as TB
    from uncertainty_vit_tpu_torch.cli import finetune as FT
    from uncertainty_vit_tpu_torch.core.config import get_preset
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.data.pipeline import BatchLoader
    from uncertainty_vit_tpu_torch.models.dist_vit import DistVisionTransformer
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import philox as P
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.parallel import seq

    t_phase = time.perf_counter()
    n_train, n_test, b, depth, k = PHASE29_SIZES
    data, s_size, _ = PHASE29_MESH
    split = depth // 2
    fwd = -(-n_test // (data * b))  # eval batches a rank
    steps = -(-n_train // data) // b  # train steps a rank and epoch (padded, tail dropped)
    rs = np.random.RandomState(29)
    want0 = {k_: 0 for k_ in kernel_counts(FA, TQ, DO)}
    paths = {}
    bounded = FA.BOUNDED_SCORES
    try:
        with tempfile.TemporaryDirectory() as tmp:
            write_cifar100(tmp, rs.randint(0, 256, (n_train, 32, 32, 3), dtype=np.uint8),
                           np.arange(n_train) % 100, "train")
            write_cifar100(tmp, rs.randint(0, 256, (n_test, 32, 32, 3), dtype=np.uint8),
                           np.arange(n_test) % 100, "test")
            cfg = get_preset("beit_base_patch16_224", num_classes=100, use_shared_rel_pos_bias=True,
                             use_abs_pos_emb=False, init_values=0.1, depth=depth)
            pth = os.path.join(tmp, "vitb224.pth")
            write_vitb_pth(torch, dev, cfg, pth, 290)
            dist_pth = os.path.join(tmp, "dist.pth")
            gen = torch.Generator(device=dev).manual_seed(291)
            seeded = DistVisionTransformer(cfg, torch.bfloat16, device=dev, generator=gen)
            trunc_normal(0.2, 2.0)(seeded.rel_pos_bias.relative_position_bias_table, gen)
            trunc_normal(0.5, 2.0)(seeded.head.weight, gen)
            torch.save({"model": {k_: v.cpu() for k_, v in seeded.state_dict().items()}},
                       dist_pth)
            del seeded

            def argv(name, size, batch, *extra, train=False, dtype="float32", s=1,
                     model="beit_base_patch16"):
                return ["--model", f"{model}_{size}", "--input_size", str(size),
                        "--target_layer", str(depth - 1), "--data_set", "CIFAR100",
                        "--data_path", tmp, "--num_workers", "4", "--batch_size", str(batch),
                        "--finetune", dist_pth if model.startswith("dist") else pth,
                        "--output_dir", os.path.join(tmp, name), "--dtype", dtype,
                        "--no_auto_resume", *([] if train else ["--eval"]), *extra,
                        "--seq_parallel", str(s)]

            epochs = ["--epochs", "2", "--warmup_epochs", "1", "--layer_decay", "0.65",
                      "--save_ckpt_freq", "1", "--disable_eval_during_finetuning"]
            one_step = ["--epochs", "1", "--steps_per_epoch", "1",
                        "--disable_eval_during_finetuning", "--no_save_ckpt"]
            drop = ["--attn_drop_rate", str(PHASE29_ATTN_DROP)]
            mc = ["--mc_dropout", "--mc_dropout_forwards", str(k), "--drop", "0.1", *drop]
            # name → (size, extra flags, trains, layout, mutation, dtype, a rank's launches)
            int8 = ["--quant", "int8"]
            cases = {
                "int8_train": (384, int8 + epochs, True, "mesh", None, "float32",
                               dict(K5=2 * steps * depth, K5_bwd=2 * steps * depth,
                                    K6=2 * steps * 8 * depth, K7=2 * steps * 4 * depth)),
                "int8_image0_zero": (384, int8 + one_step, True, "mesh", "image0_zero",
                                     "float32", dict(K5=depth, K5_bwd=depth, K6=8 * depth,
                                                     K7=4 * depth)),
                "int8_eval": (384, int8, False, "mesh", None, "bfloat16",
                              dict(K5=fwd * depth, K6=fwd * 4 * depth)),
                "attn_drop_train": (224, drop + ["--epochs", "1", "--steps_per_epoch", "2",
                                                 "--disable_eval_during_finetuning",
                                                 "--no_save_ckpt"], True, "pair", None,
                                    "float32", dict(K1=2 * depth, K2=2 * depth)),
                "attn_drop_train_384": (384, drop + one_step, True, "pair", None, "float32",
                                        dict(K3=depth, K4=depth)),
                "mc_folded": (224, mc, False, "pair", None, "float32",
                              dict(K1=fwd * depth, K8=2 * fwd * depth)),
                "mc_split": (224, mc + ["--mc_dropout_split_at", str(split),
                                        "--dropout_from_block", str(split)], False, "pair",
                             None, "float32", dict(K1=fwd * depth, K8=2 * fwd * (depth - split))),
                "adahessian": (384, ["--opt", "adahessian", "--lr", "1e-3", "--warmup_epochs",
                                     "1", *one_step], True, "mesh", None, "float32",
                               dict(K5=depth, K5_bwd=depth)),
                "adahessian_unsummed": (384, ["--opt", "adahessian", "--lr", "1e-3",
                                              "--warmup_epochs", "1", *one_step], True, "mesh",
                                        "hz_unsummed", "float32", dict(K5=depth, K5_bwd=depth)),
                "stochastic_train": (224, ["--stochastic", "--epochs", "2", "--warmup_epochs",
                                           "1", "--save_ckpt_freq", "1", "--drop_path", "0.1"],
                                     True, "pair", None, "float32", {}),
                "stochastic_eval": (224, ["--stochastic"], False, "pair", None, "float32", {}),
            }

            def case_argv(name, batch, one=False):
                size, extra, trains, layout, _, dtype, _ = cases[name]
                model = "dist_beit_base_patch16" if name.startswith("stochastic") else \
                    "beit_base_patch16"
                s = 1 if one or layout == "pair" else s_size
                return argv(name + ("_one" if one else ""), size, batch, *extra, train=trains,
                            dtype=dtype, s=s, model=model)

            rank_cases = [(name, case_argv(name, b), c[3], c[4]) for name, c in cases.items()]

            # --- one process given the global batch
            one = {}
            loader = TB.BatchLoader

            def one_process(name):
                TB.BatchLoader = functools.partial(BatchLoader, hosts_per_batch=data)
                try:
                    one[name] = phase29_run(torch, np, FT, FA, TQ, DO, dev,
                                            case_argv(name, data * b, one=True))
                finally:
                    TB.BatchLoader = loader
                torch.cuda.empty_cache()

            # the runs whose step 0 the ranks hold in place, saved for them
            refs = {}
            for name, mutated in (("int8_train", "int8_image0_zero"),
                                  ("adahessian", "adahessian_unsummed")):
                one_process(name)
                path = os.path.join(tmp, f"{name}_step0.pt")
                torch.save({"grads": one[name]["step0"]["grads"]} if name.startswith("int8")
                           else {"hessian": [h.cpu() for h in one[name]["hessians"][0]]}, path)
                refs[name] = refs[mutated] = path

            # --- the four ranks
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = seq.run_ranks(data_axis_rank, data * s_size, str(dev), rank_cases, refs,
                                  timeout=900.0, mesh=PHASE29_MESH)
            ranks_s = time.perf_counter() - t0
            for r, (res, _, _) in enumerate(ranks):
                for name, run in res.items():
                    exp = dict(want0, **cases[name][6])
                    check(run["launches"] == exp,
                          f"29 rank {r} {name} launched {run['launches']}, expected {exp}")
            for name in cases:
                paths[f"cli19_mesh_{name}"] = {
                    k_: sum(res[name]["launches"][k_] for res, _, _ in ranks) for k_ in want0}
            print(f"  29 four ranks as mesh {PHASE29_MESH} ({card_line()}), launches a rank: "
                  + "; ".join(f"{n}: {run['launches']}" for n, run in ranks[0][0].items()),
                  flush=True)
            print("  29 seconds a run on rank 0 (host clock, model build and .pth import "
                  "included): " + ", ".join(f"{n} {run['s']:.2f}" for n, run in
                                            ranks[0][0].items())
                  + f"; the ranks ran {ranks_s:.1f} s from start to end", flush=True)

            for name, c in cases.items():
                if c[4] is None and name not in one:  # the mutations run on the ranks alone
                    one_process(name)
            for name, run in one.items():
                n = cases[name][6]
                # one process runs K3 / K4 (N = 577) where a rank of the mesh runs K5
                exp = dict(want0, **{k_: v for k_, v in n.items() if k_ not in ("K5", "K5_bwd")})
                exp["K3"] += n.get("K5", 0)
                exp["K4"] += n.get("K5_bwd", 0)
                check(run["launches"] == exp, f"29 one process {name} launched "
                                              f"{run['launches']}, expected {exp}")
                paths[f"cli19_one_{name}"] = run["launches"]

            # --- the holds
            worst = {}
            for name in ("int8_eval", "mc_folded", "mc_split"):
                bound_ = LOGIT_REL_BOUND if cases[name][5] == "bfloat16" \
                    else PHASE28_F32_REL_BOUND
                ref, rel = one[name]["reads"], 0.0
                for res, _, (d, _) in ranks:
                    got = res[name]["reads"]
                    check(len(got) == len(ref) > 0, f"29 {name}: {len(got)} reads on a rank, "
                                                    f"{len(ref)} in one process")
                    for g, w in zip(got, ref):
                        part = w[d * len(g):(d + 1) * len(g)]
                        check(g.shape == part.shape, f"29 {name}: shapes {g.shape} / {part.shape}")
                        if np.issubdtype(w.dtype, np.floating):
                            rel = max(rel, float(np.abs(g - part).max())
                                      / max(float(np.abs(w).max()), 1e-30))
                        else:
                            check(np.array_equal(g, part), f"29 {name}: the labels differ")
                worst[name] = rel
                check(rel <= bound_, f"29 {name}: the ranks' arrays differ from one process's "
                                     f"rows by {rel:.3e} of their largest value (bound {bound_})")
                got, want = ranks[0][0][name]["result"], one[name]["result"]
                for key, metrics in want.items():
                    for m, v in metrics.items():
                        if m in ("acc1", "acc5"):
                            ok = abs(got[key][m] - v) * n_test / 100 <= \
                                (1 if bound_ > 1e-3 else 0) + 1e-6
                        else:
                            ok = _held(got[key][m], v, bound_)
                        check(ok, f"29 {name}: {m} {got[key][m]} on the mesh, {v} in one process")
            # the kernels' masks through the fold against one process's rows, to the bit
            masks = []
            for name in ("attn_drop_train", "attn_drop_train_384", "mc_folded", "mc_split"):
                (shape1, _, h1, seed1, _, fold1), bits1, full1 = one[name]["attn"]
                check(fold1 is None, f"29 {name}: one process's attention call had a fold")
                mask1 = torch.from_numpy(np.unpackbits(bits1)[:int(np.prod(full1))]
                                         .reshape(full1).astype(bool))
                for res, _, (d, q) in ranks:
                    (shape, _, _, seed, _, fold), bits, full = res[name]["attn"]
                    check(seed == seed1 and fold == (b, data * b, d * b),
                          f"29 {name}: rank ({d}, {q}) drew seed {seed} (one process {seed1}), "
                          f"fold {fold}")
                    mask = torch.from_numpy(np.unpackbits(bits)[:int(np.prod(full))]
                                            .reshape(full).astype(bool))
                    rows = P.fold_images(shape[0], fold)
                    check(torch.equal(mask, mask1[rows]), f"29 {name}: rank ({d}, {q})'s "
                          f"attention mask through the fold {fold} is not one process's rows")
                masks.append(f"{name} {tuple(full)}")
                if name.startswith("mc"):
                    (shape1, _, seed1, window1, fold1), k8_1 = one[name]["k8"]
                    for res, _, (d, q) in ranks:
                        (shape, _, seed, window, fold), k8 = res[name]["k8"]
                        rows = P.fold_images(shape[0], fold)
                        check(seed == seed1 and torch.equal(
                            k8.reshape(shape[0], -1), k8_1.reshape(shape1[0], -1)[rows]),
                            f"29 {name}: rank ({d}, {q})'s K8 mask is not one process's rows")
            # the training runs: steps' losses and gradient norms, epochs' losses
            for name in ("int8_train", "attn_drop_train", "attn_drop_train_384", "adahessian"):
                for res, _, _ in ranks:
                    got, ref = res[name]["steps"], one[name]["steps"]
                    check(len(got) == len(ref) > 0, f"29 {name}: {len(got)} / {len(ref)} steps")
                    for i, (g, w) in enumerate(zip(got, ref)):
                        for key in ("loss", "grad_norm"):
                            check(_held(g[key], w[key], PHASE28_F32_REL_BOUND),
                                  f"29 {name} step {i}: {key} {g[key]} on the mesh, {w[key]} "
                                  "in one process")
            logs = {}
            for name, tag in (("int8_train", ""), ("stochastic_train", "_pair0"),
                              ("stochastic_train", "_pair1")):
                pair = []
                for which in (name + tag, name + "_one"):
                    with open(os.path.join(tmp, which, "log.txt")) as f:
                        pair.append([json.loads(line) for line in f])
                check(len(pair[0]) == len(pair[1]) == 2, f"29 {name}{tag}: log.txt's epochs")
                for e, (g, w) in enumerate(zip(*pair)):
                    for key in [kk for kk in w if kk.startswith("train_") and "lr" not in kk]:
                        check(_held(g[key], w[key], PHASE28_F32_REL_BOUND),
                              f"29 {name}{tag} epoch {e}: {key} {g[key]} on the mesh, {w[key]} "
                              "in one process")
                logs[name] = [(g["train_loss"], w["train_loss"]) for g, w in zip(*pair)]
            got, want = ranks[0][0]["stochastic_eval"]["result"], one["stochastic_eval"]["result"]
            for m, v in want["dist_eval"].items():
                check(_held(got["dist_eval"][m], v, PHASE28_F32_REL_BOUND) if m not in
                      ("acc1", "acc5") else got["dist_eval"][m] == v,
                      f"29d --eval --stochastic: {m} {got['dist_eval'][m]} on the mesh, {v} in "
                      "one process")
            # 29a: step 0's gradients, and the mutation's (held in each rank)
            int8 = {name: {key: max(res[name]["int8"][key] for res, _, _ in ranks)
                           for key in ("total", "worst", "last")}
                    for name in ("int8_train", "int8_image0_zero")}
            print(f"  29a step 0's int8 gradients against one process's, norm of the "
                  f"difference over the norm (all tensors, the worst tensor, the last block's "
                  f"worst int8 weight): {json.dumps(int8)}; the worst tensors "
                  f"{ranks[0][0]['int8_train']['int8']['worst_name']} / "
                  f"{ranks[0][0]['int8_image0_zero']['int8']['worst_name']}", flush=True)
            int8_rel = {name: v["total"] for name, v in int8.items()}
            for key, bound_ in (("total", PHASE29_INT8_TOTAL_REL),
                                ("last", PHASE29_INT8_LAST_REL)):
                check(int8["int8_train"][key] <= bound_,
                      f"29a: the int8 step 0's gradients ({key}) differ from one process's by "
                      f"{int8['int8_train'][key]:.3e} of their norm (bound {bound_})")
                check(int8["int8_image0_zero"][key] > bound_,
                      f"29a: with image0 = 0 the gradients ({key}) differ by only "
                      f"{int8['int8_image0_zero'][key]:.3e}: the hold would not see it")
            # 29a: the layer probe: K7's sums add up, K6's dgrad rows are one process's
            dx1, acc1 = int8_probe(torch, dev)
            total = sum(acc.long() for _, (_, acc), _ in ranks)
            check(torch.equal(total, acc1.long()), "29a: the four ranks' K7 int32 sums do not "
                                                   "add up to one process's")
            images_, n_tok = PHASE29_PROBE[:2]
            for res, (dx, _), (d, q) in ranks:
                shard = seq.SeqGroup(q, s_size).shard(n_tok)
                want_dx = dx1[d * b:(d + 1) * b, shard.start:shard.stop]
                check(torch.equal(dx, want_dx), f"29a: rank ({d}, {q})'s K6 dgrad is not one "
                                                "process's rows")
            # 29c: D = z * Hz against one process's, and the mutation's (held in
            # each rank)
            hz = {name: max(res[name]["hz"] for res, _, _ in ranks)
                  for name in ("adahessian", "adahessian_unsummed")}
            for res, _, _ in ranks:
                check(res["adahessian"]["hessians"] == 1, "29c: Hessian estimates")
            check(hz["adahessian"] <= PHASE28_HESSIAN_REL_BOUND,
                  f"29c: D on the mesh differs from one process's by {hz['adahessian']:.3e} of "
                  f"max|D| (bound {PHASE28_HESSIAN_REL_BOUND})")
            check(hz["adahessian_unsummed"] > PHASE28_HESSIAN_REL_BOUND,
                  f"29c: with Hz unsummed over the data group D differs by only "
                  f"{hz['adahessian_unsummed']:.3e}: the hold would not see it")
            print("  29 the ranks against one process, max|diff| / max|value| of the arrays "
                  f"read back (bound {LOGIT_REL_BOUND} in bf16, {PHASE28_F32_REL_BOUND} in f32): "
                  + ", ".join(f"{n} {v:.3e}" for n, v in worst.items())
                  + "; the attention kernels' masks through the fold equal to the bit to their "
                  "plain versions' and one process's rows (" + ", ".join(masks) + "), K8's too; "
                  "epochs' losses (mesh / one process) "
                  + "; ".join(f"{n} " + ", ".join(f"{g:.6f} / {w:.6f}" for g, w in v)
                              for n, v in logs.items())
                  + f"; 29a step 0's gradients {int8_rel['int8_train']:.3e} of their norm "
                  f"({int8['int8_train']['last']:.3e} in the last block), with image0 = 0 "
                  f"{int8_rel['int8_image0_zero']:.3e} ({int8['int8_image0_zero']['last']:.3e}; "
                  f"bounds {PHASE29_INT8_TOTAL_REL}, {PHASE29_INT8_LAST_REL}); K7's sums of the "
                  f"four ranks equal to one process's, K6's dgrad rows too; 29c max|dD| / "
                  f"max|D| {hz['adahessian']:.3e}, with Hz unsummed "
                  f"{hz['adahessian_unsummed']:.3e} (bound "
                  f"{PHASE28_HESSIAN_REL_BOUND})", flush=True)
            print("  29 launches a path, summed over the ranks: "
                  + "; ".join(f"{p}: " + ", ".join(f"{k_} {v}" for k_, v in n.items() if v)
                              for p, n in paths.items() if p.startswith("cli19_mesh_"))
                  + "; one process's seconds a run: "
                  + ", ".join(f"{n} {r['s']:.2f}" for n, r in one.items()), flush=True)
    finally:
        FA.BOUNDED_SCORES = bounded
    # K1 with dropout through a fold and K6's dgrad through an image offset,
    # each beside its flat call in one call of in_turns
    gen = torch.Generator(device=dev).manual_seed(2900)
    h, hd = 12, 64
    qkv = torch.randn(128, 197, 3 * h * hd, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(h, 197, 197, generator=gen, device=dev) * 0.5
    s = torch.tensor([291], dtype=torch.int64, device=dev)
    k1_best, k1_runs = in_turns({
        "flat": lambda: FA.fused_qkv_attention(qkv, bias, None, s, hd**-0.5, h, 0.1,
                                               bounded_scores=True),
        "fold": lambda: FA.fused_qkv_attention(qkv, bias, None, s, hd**-0.5, h, 0.1,
                                               bounded_scores=True, fold=(64, 128, 64))}, 20)
    del qkv, bias
    x = torch.randn(M_TRAIN, 2304, generator=gen, device=dev).to(torch.bfloat16)
    wq, ws = TQ.quantize_cols(torch.randn(768, 2304, generator=gen, device=dev).t())
    k6_best, k6_runs = in_turns({
        "flat": lambda: TQ.qmm(x, wq, ws, None, s, True, torch.bfloat16),
        "offset": lambda: TQ.qmm(x, wq, ws, None, s, True, torch.bfloat16,
                                 (197, 0, 197, 160))}, 20)
    del x
    # K1-K4 through a fold at the main path's widths: each of two data ranks
    # holds 64 images of a batch of 128 as the MC-dropout fold (32, 64,
    # 32·r) lays them out (two folds of 64, so the map's division counts);
    # its forward and its K2 / K4 replay equal the unfolded call's rows to
    # the bit, and its plain versions through the same fold within phase
    # 1's and phase 3's bounds
    folds_held = []
    for n_tok, dtype in ((197, torch.bfloat16), (577, torch.float32)):
        name = str(dtype).split(".")[1]
        qkv = (torch.randn(128, n_tok, 3 * h * hd, generator=gen, device=dev) * 0.5).to(dtype)
        bias = torch.randn(h, n_tok, n_tok, generator=gen, device=dev) * 0.5
        g = torch.randn(128, n_tok, h * hd, generator=gen, device=dev).to(dtype)
        out_w, lse_w = FA.fused_qkv_attention(qkv, bias, None, s, hd**-0.5, h, 0.1,
                                              bounded_scores=True, want_lse=True)
        dqkv_w, _, _ = FA.fused_qkv_attention_bwd(qkv, bias, None, lse_w, g, hd**-0.5, h,
                                                  out=out_w, want_dbias=False, seed=s,
                                                  dropout_rate=0.1)
        errs = {"out": 0.0, "dqkv": 0.0, "dbias": 0.0}
        for r in range(2):
            fold = (32, 64, 32 * r)
            rows = P.fold_images(64, fold, dev)
            qkv_r, g_r = qkv[rows].contiguous(), g[rows].contiguous()
            out, lse = FA.fused_qkv_attention(qkv_r, bias, None, s, hd**-0.5, h, 0.1,
                                              bounded_scores=True, want_lse=True, fold=fold)
            dqkv, dbias, _ = FA.fused_qkv_attention_bwd(qkv_r, bias, None, lse, g_r, hd**-0.5, h,
                                                        out=out, seed=s, dropout_rate=0.1,
                                                        fold=fold)
            check(torch.equal(out, out_w[rows]) and torch.equal(dqkv, dqkv_w[rows]),
                  f"29: K{1 if n_tok <= 256 else 3} / K{2 if n_tok <= 256 else 4} through the "
                  f"fold {fold} at N={n_tok} are not the unfolded call's rows")
            ref, _ = FA.fused_qkv_attention_plain(qkv_r, bias, None, hd**-0.5, h,
                                                  bounded_scores=True, seed=s, dropout_rate=0.1,
                                                  fold=fold)
            check(torch.allclose(out.float(), ref.float(), atol=OUT_TOL[name],
                                 rtol=OUT_TOL[name]),
                  f"29: the forward through the fold {fold} at N={n_tok} disagrees with its "
                  "plain version")
            errs["out"] = max(errs["out"], (out.float() - ref.float()).abs().max().item())
            del ref
            ref_dqkv, ref_dbias, _ = FA.fused_qkv_attention_bwd_plain(
                qkv_r, bias, None, lse, g_r, hd**-0.5, h, out=out, seed=s, dropout_rate=0.1,
                fold=fold)
            for what, got_, ref_ in (("dqkv", dqkv, ref_dqkv), ("dbias", dbias, ref_dbias)):
                rel = ((got_.float() - ref_.float()).abs().max()
                       / ref_.float().abs().max()).item()
                errs[what] = max(errs[what], rel)
                check(rel <= BWD_TOL[name][what],
                      f"29: the backward's {what} through the fold {fold} at N={n_tok} is "
                      f"{rel:.3e} of max|plain| off its plain version (bound "
                      f"{BWD_TOL[name][what]})")
            del ref_dqkv, ref_dbias, out, lse, dqkv, dbias
        folds_held.append(f"N={n_tok} {name}: max|out-plain| {errs['out']:.3e}, dqkv "
                          f"{errs['dqkv']:.3e}, dbias {errs['dbias']:.3e} of max|plain|")
        del qkv, bias, g, out_w, lse_w, dqkv_w
        torch.cuda.empty_cache()
    print("  29 K1-K4 through the fold (32, 64, 32r) at B=128, H=12, dropout 0.1: forward and "
          "dqkv equal to the unfolded call's rows to the bit; against the plain versions "
          + "; ".join(folds_held), flush=True)
    print(f"  29 ({card_line()}) K1 at B=128 N=197 H=12 bf16, bias, bounded, dropout 0.1: "
          f"{k1_best['flat']:.4f} ms flat, {k1_best['fold']:.4f} through the fold (64, 128, 64) "
          f"(both turns {k1_runs}); K6's stochastic qkv dgrad at M={M_TRAIN}: "
          f"{k6_best['flat']:.4f} ms without a window, {k6_best['offset']:.4f} through the "
          f"image offset 160 (both turns {k6_runs})", flush=True)
    print(f"  29 (information only; {card_line()}; four ranks sharing one card through host "
          f"memory, not a multi-card rate): the phase took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return paths, {"k1_fold_ms": k1_best["fold"], "k1_flat_ms": k1_best["flat"],
                   "k6_offset_ms": k6_best["offset"], "k6_flat_ms": k6_best["flat"]}


# Phase 30's head widths beyond 64 and 80, each (D, H of K1 / K2 at ViT-B/16
# 224's shapes, H of K3-K5 at ViT-L/16 512's): C = H D is a preset's width
# where one is (768 ViT-B's, 1024 ViT-L's; 8 x 112 = 896 is none).
PHASE30_WIDTHS = ((32, 24, 24), (48, 16, 16), (96, 8, 8), (112, 8, 8), (128, 6, 8))
# Its full-width models through create_model's num_heads override: (registry
# name, heads, (eval batches, eval batch), (train steps, train batch)); the
# first two are the ViT-B and ViT-L presets with heads of 128.
PHASE30_MODELS = (("beit_base_patch16_224", 6, (4, 128), (3, 160)),
                  ("beit_large_patch16_512", 8, (2, 16), (3, 8)),
                  ("beit_base_patch16_224", 24, (1, 128), (1, 160)),
                  ("beit_base_patch16_224", 16, (1, 128), (1, 160)),
                  ("beit_base_patch16_224", 8, (1, 128), (1, 160)))


def phase30(torch, FA, dev):
    """The head widths slice: (a) K1-K5 at each D of PHASE30_WIDTHS through
    phases 1, 3, 7, 8 and 14; (b) the PHASE30_MODELS. Returns ({kernel:
    {"d<D>": its entry}}, the launches of each path)."""
    by_width = {key: {} for key in ("K1", "K2", "K3", "K4", "K5")}
    for d, h_b, h_l in PHASE30_WIDTHS:
        for key, title, fn, h in (
                ("K1", "phase 1's cases; B=128 and the train step's B=160", phase1, h_b),
                ("K2", "phase 3's cases; the train step's B=160", phase3, h_b),
                ("K3", "phase 7's cases; ViT-L/16 512's shapes", phase7, h_l),
                ("K4", "phase 8's cases; ViT-L/16 512's train shape", phase8, h_l),
                ("K5", "phase 14's cases and shards; one shard at B=8, N=1025", phase14, h_l)):
            print(f"  (a) {key} at head width {d}, {h} heads: {title}", flush=True)
            by_width[key][f"d{d}"] = {"heads": h, **fn(torch, FA, dev, d=d, h=h)}
    paths = {}
    for name, heads, evals, steps in PHASE30_MODELS:
        paths.update(phase30_model(torch, FA, dev, name, heads, evals, steps))
    phase30_unbuilt(torch, dev)
    return by_width, paths


def phase30_unbuilt(torch, dev):
    """(c) Head width 72, which the kernels are not built for: a module of
    16 heads (the reference's head group 16 takes its kernels) refuses the
    card, one of 8 (no head group does: the reference runs plain attention)
    runs the plain attention, finite."""
    from uncertainty_vit_tpu_torch.models.layers import Attention

    for heads, refused in ((16, True), (8, False)):
        attn = Attention(heads * 72, heads, device=dev)
        x = torch.randn(2, 197, heads * 72, device=dev)
        try:
            with torch.no_grad():
                out = attn(x)
            raised = False
        except NotImplementedError:
            raised = True
        check(raised == refused and attn.unbuilt_kernel == refused,
              f"{heads} heads of 72: refused {raised}, wanted {refused}")
        if not refused:
            check(out.shape == x.shape and bool(torch.isfinite(out).all()),
                  f"{heads} heads of 72: the plain attention's output is not finite")
        print(f"  (c) {heads} heads of 72: {'refused' if raised else 'plain attention'}",
              flush=True)


def phase30_model(torch, FA, dev, name, heads, evals, steps):
    """(b) One registry model with ``heads`` heads at its preset's width
    (``create_model(name, num_heads=heads)``; shared rel-pos bias, layer
    scale 0.1, seeded weights, the rel-pos table at std 0.2, bf16 on f32
    parameters, the bounded softmax as cli/finetune.py runs): evaluate() over
    ``evals`` = (batches, batch) of uint8 images (K1 or K3 a block a forward
    and nothing else; batch 0's logits against the plain attention's, the
    metrics against a CPU recomputation), ``steps`` = (steps, batch) finetune
    steps (phase 4's step: batch mixup, AdamW with layer decay 0.65 at 224,
    phase 9's 0.75 at 512, drop-path 0.1, the state halfway up the warm-up so
    that every step moves every parameter; K1 / K2 or K3 / K4 a block a step)
    and one step against the same step on the plain attention (at 512 at
    batch 2). Returns the launches of each path, named
    "<b|l><res>_<H>x<D>_"."""
    from uncertainty_vit_tpu_torch.core.init import trunc_normal
    from uncertainty_vit_tpu_torch.evals import metrics as M
    from uncertainty_vit_tpu_torch.evals.classification import evaluate, make_eval_forward
    from uncertainty_vit_tpu_torch.models.registry import create_model
    from uncertainty_vit_tpu_torch.ops import dropout as DO
    from uncertainty_vit_tpu_torch.ops import quant as TQ
    from uncertainty_vit_tpu_torch.ops.augment import (
        IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD, normalize, to_float,
    )
    from uncertainty_vit_tpu_torch.train.engine_finetune import (
        FinetuneHParams, init_finetune_state, make_finetune_train_step,
    )
    from uncertainty_vit_tpu_torch.train.optim import make_optimizer
    from uncertainty_vit_tpu_torch.train.schedules import cosine_schedule

    FA.BOUNDED_SCORES = True
    kw = dict(num_heads=heads, use_shared_rel_pos_bias=True, init_values=0.1)
    gen = torch.Generator(device=dev).manual_seed(30 + heads)
    model, cfg = create_model(name, dtype=torch.bfloat16, device=dev, generator=gen, **kw)
    d, n, res = cfg.head_dim, cfg.num_patches + 1, cfg.img_size
    route = FA.route(n)
    fwd_key, bwd_key = ("K1", "K2") if route == "fused" else ("K3", "K4")
    tag = f"{name.split('_')[1][0]}{res}_{heads}x{d}"
    check(cfg.num_heads == heads and d * heads == cfg.embed_dim and d in FA.KERNEL_HEAD_DIMS,
          f"{name} with num_heads={heads} is not {heads} heads of a built width: {cfg}")
    check(all(blk.attn.use_kernel for blk in model.blocks),
          f"a block of {tag} does not take the attention kernels")
    trunc_normal(0.2, 2.0)(model.rel_pos_bias.relative_position_bias_table, gen)
    trunc_normal(0.5, 2.0)(model.head.weight, gen)  # the logits stand apart: stable ranks
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    print(f"  (b) {name} with {heads} heads of {d} ({tag}): "
          f"{sum(p.numel() for p in model.parameters())} params, depth {cfg.depth}, width "
          f"{cfg.embed_dim}, N={n} on the {route} route ({fwd_key} / {bwd_key})", flush=True)

    def counts():
        return kernel_counts(FA, TQ, DO)

    none = {k: 0 for k in counts()}
    # --- evaluate()
    nb, bs = evals
    images = [torch.randint(0, 256, (bs, res, res, 3), generator=gen, device=dev,
                            dtype=torch.uint8) for _ in range(nb)]
    labels = [torch.randint(0, cfg.num_classes, (bs,), generator=gen, device=dev)
              for _ in range(nb)]

    def batches():
        for u8, lbl in zip(images, labels):
            yield normalize(to_float(u8), IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD), lbl

    reset_kernel_counts(FA, TQ, DO)
    metrics = evaluate(model, batches())
    torch.cuda.synchronize()
    launches = {f"{tag}_evaluate": counts()}
    want = dict(none, **{fwd_key: cfg.depth * nb})
    print(f"  evaluate() over {nb} x {bs}: launches {launches[f'{tag}_evaluate']}; "
          f"{json.dumps(metrics)}", flush=True)
    check(launches[f"{tag}_evaluate"] == want,
          f"{tag} evaluate() launched {launches[f'{tag}_evaluate']}, expected {want}")
    fwd = make_eval_forward(model)
    logits = torch.cat([fwd(x) for x, _ in batches()])
    check(tuple(logits.shape) == (bs * nb, cfg.num_classes) and logits.dtype == torch.float32
          and torch.isfinite(logits).all().item(), f"{tag} logits are not finite f32")
    on_cpu = {k: float(v) for k, v in
              M.classification_metrics(logits.cpu(), torch.cat(labels).cpu()).items()}
    on_cpu["loss"] = on_cpu["nll"]
    check(sorted(metrics) == sorted(on_cpu), f"evaluate()'s metric keys {sorted(metrics)}")
    for k, v in on_cpu.items():
        check(abs(metrics[k] - v) <= METRIC_ATOL + METRIC_RTOL * abs(v),
              f"{tag} evaluate()'s {k} {metrics[k]} against the CPU's {v} from the same logits")
    x0 = next(batches())[0]
    with attention_on_plain(torch, FA):
        ref = fwd(x0)
    diff, scale = (logits[:bs] - ref).abs().max().item(), ref.abs().max().item()
    print(f"  logits {fwd_key} vs plain attention: max|diff|={diff:.3e}, max|logit|={scale:.3e}, "
          f"ratio {diff / scale:.3e} (bound {LOGIT_REL_BOUND}); evaluate()'s metrics equal the "
          f"CPU's from the same logits", flush=True)
    check(diff <= LOGIT_REL_BOUND * scale, f"{tag} logits disagree with the plain attention")
    eval_ms = [cuda_ms(lambda: fwd(x0), 3) for _ in range(2)] if nb > 1 else []
    del logits, ref, images, model

    # --- the finetune train step
    def build():
        m, c = create_model(name, dtype=torch.bfloat16, device=dev, drop_path_rate=0.1,
                            generator=torch.Generator(device=dev).manual_seed(0), **kw)
        m.load_state_dict(init)
        opt = make_optimizer(m, weight_decay=0.05, layer_decay=0.65 if res == 224 else 0.75,
                             depth=c.depth)
        state = init_finetune_state(m, opt)
        state.step = 250
        step = make_finetune_train_step(m, opt, FinetuneHParams(num_classes=c.num_classes),
                                        cosine_schedule(4e-3, 1e-6, 10_000, warmup_steps=500))
        return m, state, step

    def gens(seed):
        return large_512_gens(torch, dev, seed)

    n_steps, bt = steps
    x = torch.randn(bt, res, res, 3, generator=gen, device=dev)
    y = torch.randint(0, cfg.num_classes, (bt,), generator=gen, device=dev)
    tmodel, state, step = build()
    reset_kernel_counts(FA, TQ, DO)
    ms = [step(state, x, y, *gens(11 + i)) for i in range(n_steps)]
    torch.cuda.synchronize()
    launches[f"{tag}_train_step"] = counts()
    want = dict(none, **{fwd_key: cfg.depth * n_steps, bwd_key: cfg.depth * n_steps})
    print(f"  {n_steps} steps at batch {bt}: launches {launches[f'{tag}_train_step']}; "
          + "; ".join(f"loss {float(m['loss']):.5f} grad_norm {float(m['grad_norm']):.5f}"
                      for m in ms), flush=True)
    check(launches[f"{tag}_train_step"] == want,
          f"{tag}'s {n_steps} steps launched {launches[f'{tag}_train_step']}, expected {want}")
    check(all(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"]))
              for m in ms), f"{tag}: non-finite loss or grad norm")
    moved = 0
    for k, v in tmodel.state_dict().items():
        check(torch.isfinite(v).all().item(), f"{tag}: non-finite parameter {k}")
        moved += int(not torch.equal(v, init[k]))
    check(moved == len(init), f"{tag}: only {moved} of {len(init)} parameter tensors changed")
    if n_steps > 1:
        g = gens(20)
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
        train_ms = [cuda_ms(lambda: step(state, x, y, *g), 3) for _ in range(2)]
        retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
        clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                 "--format=csv,noheader"], capture_output=True, text=True,
                                timeout=60).stdout.strip()
        print(f"  information only: eval forward at batch {bs} "
              f"{[bs * 1000 / t for t in eval_ms]} img/s ({eval_ms} ms); train step at batch "
              f"{bt} {[bt * 1000 / t for t in train_ms]} img/s ({train_ms} ms); while timing "
              f"the steps {retries} allocator retries, "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved; after them "
              f"SM clock, power {clocks}", flush=True)
    del tmodel, state, step

    # one step from the same weights and seeds on the kernels and on the plain
    # attention (at 512 at batch 2: the plain path saves [B, H, N, N] tensors)
    bh = bt if res == 224 else 2
    _, st_k, step_k = build()
    reset_kernel_counts(FA, TQ, DO)
    m_k = step_k(st_k, x[:bh], y[:bh], *gens(30))
    torch.cuda.synchronize()
    launches[f"{tag}_train_step_held"] = counts()
    want = dict(none, **{fwd_key: cfg.depth, bwd_key: cfg.depth})
    check(launches[f"{tag}_train_step_held"] == want,
          f"{tag}'s held step launched {launches[f'{tag}_train_step_held']}")
    del st_k, step_k
    _, st_p, step_p = build()
    with attention_on_plain(torch, FA):
        m_p = step_p(st_p, x[:bh], y[:bh], *gens(30))
    torch.cuda.synchronize()
    check(counts() == launches[f"{tag}_train_step_held"],
          "the plain-attention reference step launched a kernel")
    del st_p, step_p
    loss_k, loss_p = float(m_k["loss"]), float(m_p["loss"])
    gn_k, gn_p = float(m_k["grad_norm"]), float(m_p["grad_norm"])
    print(f"  one step at batch {bh}, {fwd_key}/{bwd_key} vs their plain versions: loss "
          f"{loss_k:.6f} / {loss_p:.6f}, grad norm {gn_k:.6f} / {gn_p:.6f}", flush=True)
    check(abs(loss_k - loss_p) <= LOSS_REL_BOUND * abs(loss_p),
          f"{tag}'s step loss disagrees with the plain versions'")
    check(abs(gn_k - gn_p) <= GRAD_NORM_REL_BOUND * abs(gn_p),
          f"{tag}'s step grad norm disagrees with the plain versions'")
    return launches


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip(), flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from uncertainty_vit_tpu_torch.ops import _native
    from uncertainty_vit_tpu_torch.ops import flash_attention as FA

    build_kernels(_native)

    dev = torch.device("cuda", 0)

    def run(number, title, fn, *fn_args):
        print(f"phase {number}: {title}", flush=True)
        t = time.perf_counter()
        out = fn(*fn_args)
        torch.cuda.synchronize()
        print(f"  phase {number} took {time.perf_counter() - t:.1f} s", flush=True)
        return out

    res = {1: run(1, "K1 against its plain version, without and with dropout",
                  phase1, torch, FA, dev)}
    eval_launches, det_ms = run(2, "ViT-B/16 224 evaluate()", phase2, torch, FA, dev)
    res[3] = run(3, "K2 against its plain version, without and with the mask replay",
                 phase3, torch, FA, dev)
    train, train_drop, step_rates = run(4, "ViT-B/16 224 finetune train steps", phase4, torch,
                                        FA, dev)
    res[5] = run(5, "K8 against its plain version", phase5, torch, dev)
    res[6] = run(6, "ViT-B/16 224 evaluate_mc_dropout()", phase6, torch, FA, dev, det_ms)
    check(FA.fused_qkv_attention.stream_launches == 0
          and FA.fused_qkv_attention_bwd.stream_launches == 0,
          "a ViT-B/16 224 path launched a streaming kernel")
    res[7] = run(7, "K3 against its plain version, without and with dropout", phase7, torch, FA,
                 dev)
    res[8] = run(8, "K4 against its plain versions, without and with the mask replay", phase8,
                 torch, FA, dev)
    large, init_512 = run(9, "ViT-L/16 512 evaluate(), finetune train steps, MC forward", phase9,
                          torch, FA, dev)
    res[10] = run(10, "K6 against its plain version, nearest and stochastic", phase10, torch, dev)
    res[11] = run(11, "K7 against its plain version", phase11, torch, dev)
    int8 = run(12, "ViT-B/16 224 with the int8 trunk: evaluate() and finetune train steps",
               phase12, torch, FA, dev, res[10]["other_ms"], res[11]["other_ms"])
    d80, huge = run(13, "ViT-H/16 224 (head width 80) on the attention kernels: K1-K5 at D=80, "
                        "evaluate(), finetune train steps, the finetune driver", phase13, torch,
                    FA, dev, step_rates)
    res[14] = run(14, "K5 against its plain version and its shards against K3/K4", phase14,
                  torch, FA, dev)
    seq2 = run(15, "ViT-L/16 512 over two gloo ranks sharing the card: evaluate(), train steps",
               phase15, torch, FA, dev, init_512)
    del init_512
    cli, cli_eval = run(16, "the finetune driver from images: --eval, --mc_dropout, "
                            "--ensembles, --quant int8", phase16, torch, FA, dev, det_ms)
    cli_train = run(17, "the finetune driver's training from images: two epochs, a resumed "
                        "third, a step on the plain attention, an int8 epoch", phase17, torch, FA,
                    dev, step_rates)
    cli7c = run(18, "the finetune driver's slice 7c at 384: accumulation, masking, elem / pair "
                    "mixup; over two gloo ranks; ViT-L/16 384 --eval", phase18, torch, FA, dev,
                step_rates)
    cli8 = run(19, "slice 8 through the driver: --sngp and --het_layer training and evaluation; "
                   "--temp_scaling, --laplace, --corrupted_data, --perturbed_data, "
                   "--visualize_embedding", phase19, torch, FA, dev)
    cli9, cyclical_rates = run(20, "the cyclical pretraining driver: two epochs at the recipe's "
                                   "flags, a step on the plain attention, a resumed third; "
                                   "--gp_layer; the hand-off to cli.finetune; an int8 step",
                               phase20, torch, FA, dev, step_rates)
    cli10 = run(21, "the BEiT pretraining drivers: the dVAE trainer, MIM with the DALL-E "
                    "tokenizer (two epochs, a step on the plain attention, a resumed third, an "
                    "int8 step), joint cyclical+BEiT, the hand-off to cli.finetune", phase21,
                torch, FA, dev, step_rates, cyclical_rates)
    cli11 = run(22, "the dist (mean+covariance) model through the drivers: --stochastic "
                    "training, --eval --stochastic, cyclical --stochastic; step 0 against "
                    "float64", phase22, torch, FA, dev, step_rates, cyclical_rates)
    cli12 = run(23, "slice 12 through the drivers: the attention variants, every --opt against "
                    "float64, AdaHessian through each engine", phase23, torch, FA, dev,
                step_rates)
    mesh = run(24, "the device mesh over gloo ranks sharing the card: ViT-B/16 224 on data 2 x "
                   "model 2 (cyclical, finetune+mixup+SNGP, dist triplet) against one process; "
                   "the port's dryrun at --devices 8", phase24, torch, FA, dev)
    cli15 = run(25, "slice 15 through the driver over two gloo ranks sharing the card at "
                    "ViT-B/16 384: MC-dropout (K8's row window), the SNGP and het heads, -C, -P, "
                    "--laplace, --temp_scaling, --visualize_embedding, against one process",
                phase25, torch, FA, dev)
    cli16 = run(26, "slice 16: the int8 trunk of ViT-L/16 512 and ViT-H/16 224 (evaluate(), "
                    "train steps, the driver), the int8 step over two gloo ranks against one "
                    "process, the golden-weights tool", phase26, torch, FA, dev)
    cli17 = run(27, "slice 17: checkpoints of the JAX package: phase 16's weights through the "
                    "JAX layout and the converter into the driver, the golden of a JAX-written "
                    "checkpoint, the refusal without tensorstore", phase27, torch, FA, dev,
                cli_eval)
    cli18 = run(28, "slice 18: the finetune driver on a data 2 x seq 2 mesh of four gloo ranks "
                    "sharing the card at ViT-B/16 384's widths: --eval, MC-dropout folded and "
                    "split (K8 through the fold), the het head, two epochs of training, "
                    "--sinkformer, --opt adahessian on the seq pairs, against one process with "
                    "the global batch", phase28, torch, FA, dev)
    cli19, fold_times = run(29, "slice 19: the finetune driver's data axis with nothing refused, "
                                "four gloo ranks sharing the card: --quant int8 on (2, 2, 1), "
                                "attention dropout and --stochastic on the data pairs, --opt "
                                "adahessian on (2, 2, 1), against one process with the global "
                                "batch; the kernels' masks and bits through the fold and the "
                                "image offset", phase29, torch, FA, dev)
    widths, width_paths = run(30, "the attention kernels at head widths 32, 48, 96, 112 and 128: "
                                  "K1-K5 at each, ViT-B/16 224 with 6 heads of 128 and ViT-L/16 "
                                  "512 with 8, ViT-B/16 224 with 24 heads of 32, 16 of 48 and 8 "
                                  "of 96", phase30, torch, FA, dev)

    # one count per run of a path, each read after its own reset: evaluate()
    # over 4 batches, 3 train steps, 1 train step with attention dropout, and
    # phase 6's evaluate_mc_dropout() over 2 batches folded and split, its one
    # K=2 forward with attention dropout and its 2-member ensemble on 1 batch
    mc = {"mc_dropout_folded": res[6]["folded"], "mc_dropout_split": res[6]["split"],
          "mc_attn_drop": res[6]["attn_drop"], "ensemble": res[6]["ensemble"]}
    # and phase 9's ViT-L/16 512 paths ("large_"): evaluate() over 2 batches, 3
    # train steps, 1 step at batch 2, 1 step with attention dropout, one K=2
    # forward with attention dropout
    # and phase 12's int8 paths: evaluate() over 4 batches, 3 train steps
    # and phase 16's driver runs ("cli_"): --eval over 1024 images, and
    # --mc_dropout, --ensembles and --quant int8 over 256; and phase 17's
    # ("cli_train"): two epochs of 4 steps and their evaluations, the third
    # epoch resumed, and an int8 epoch of 2 steps
    # and phase 19's ("cli8_"): the --sngp, exact-accumulation and --het_layer
    # training runs, the --het_layer evaluation, and the post-hoc evaluations
    # and phase 20's ("cli9_"): the cyclical driver's two epochs of 4 steps,
    # its resumed third, its --gp_layer epoch of 2, the finetune driver's
    # --eval of the last checkpoint and an int8 step; and phase 21's
    # ("cli10_"): the MIM driver's two epochs of 4 steps, its resumed third
    # and an int8 step, the joint driver's two epochs, the finetune driver's
    # --eval of the MIM checkpoint (the dVAE trainer launches none)
    # and phase 22's ("cli11_"): the dist model's training, evaluation and
    # cyclical pretraining, which launch no kernel of the port
    # and phase 23's ("cli12_"): the variants' training and --eval (no kernel
    # in their layers), every --opt's 3 updates, the AdaHessian steps
    # and phase 24's ("mesh_"): one step of each engine on the 4-rank ViT-B/16
    # mesh and on the dry run's 8 ranks, summed over the ranks
    dist_paths = {path: dict(n) for path, n in {**cli11, **cli12}.items()}
    mesh_k = {"K1": {p: n["K1"] for p, n in mesh.items() if n["K1"]},
              "K2": {p: n["K2"] for p, n in mesh.items() if n["K2"]},
              "K5": {p: n["K5"] for p, n in mesh.items() if n["K5"]}}
    k1_paths = {"evaluate": eval_launches, "train_step": train["fwd"],
                "train_step_attn_drop": train_drop["fwd"],
                **{path: n["K1"] for path, n in mc.items()},
                **{path: n["K1"] for path, n in int8.items()},
                **{path: n["K1"] for path, n in cli.items()},
                **{path: n["K1"] for path, n in cli_train.items()},
                **{path: n["K1"] for path, n in cli8.items()},
                **{path: n["K1"] for path, n in cli9.items()},
                **{path: n["K1"] for path, n in cli10.items() if n["K1"]},
                **{path: n["K1"] for path, n in dist_paths.items()}}
    k2_paths = {"train_step": train["bwd"], "train_step_attn_drop": train_drop["bwd"],
                "int8_train_step": int8["int8_train_step"]["K2"],
                **{path: n["K2"] for path, n in cli_train.items()},
                **{path: n["K2"] for path, n in cli8.items() if n["K2"]},
                **{path: n["K2"] for path, n in cli9.items() if n["K2"]},
                **{path: n["K2"] for path, n in cli10.items() if n["K2"]},
                **{path: n["K2"] for path, n in dist_paths.items()}}
    k6_paths = {path: n["K6"] for path, n in {**int8, **cli, **cli_train, **cli9, **cli10}.items()
                if n["K6"]}
    k7_paths = {path: n["K7"] for path, n in {**int8, **cli_train, **cli9, **cli10}.items()
                if n["K7"]}
    k8_paths = {path: n["K8"] for path, n in {**mc, **cli, **cli8}.items() if n["K8"]}
    for kpaths, key in ((k6_paths, "K6"), (k7_paths, "K7"), (k8_paths, "K8")):
        kpaths.update({path: n[key] for path, n in dist_paths.items()})
    # and phase 18's ("cli7c_"): ViT-B/16 384 trained (4 mini-steps and an
    # evaluation of 2 batches; 2 pair mini-steps), ViT-L/16 384 evaluated
    k3_paths = {f"large_{path}": n["K3"] for path, n in large.items()}
    k3_paths.update({path: n["K3"] for path, n in cli7c.items() if n["K3"]})
    k4_paths = {f"large_{path}": n["K4"] for path, n in large.items() if n["K4"]}
    k4_paths.update({path: n["K4"] for path, n in cli7c.items() if n["K4"]})
    k3_paths.update({path: n["K3"] for path, n in dist_paths.items()})
    k4_paths.update({path: n["K4"] for path, n in dist_paths.items()})
    for n_ in large.values():
        check(n_["K1"] == 0 and n_["K2"] == 0, "a ViT-L/16 512 path launched K1 or K2")
    # phase 15's paths ("seq2_large_": ViT-L/16 512 over two ranks), summed
    # over the ranks: evaluate() over one batch, 2 train steps; K5's forward
    # and backward launches together
    k5_paths = {f"seq2_large_{path}": n["K5"] + n["K5_bwd"] for path, n in seq2.items()}
    # and phase 18b's ViT-B/16 384 over two ranks: 2 driver steps, --eval
    # over 8 batches, summed over the ranks
    seq7c = {path: n for path, n in cli7c.items() if n["K5"]}
    k5_paths.update({path: n["K5"] + n["K5_bwd"] for path, n in seq7c.items()})
    k5_paths.update({path: n["K5"] + n["K5_bwd"] for path, n in dist_paths.items()})
    pkg = "uncertainty_vit_tpu_torch/csrc/"
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": pkg + "flash_attention_stream_fwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:188",
         "launches": sum(k1_paths.values()), "launches_by_path": k1_paths, **res[1]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": pkg + "flash_attention_stream_bwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:244",
         "launches": sum(k2_paths.values()), "launches_by_path": k2_paths, **res[3]},
        {"name": "flash_attention_stream_fwd", "route": "cuda",
         "source": pkg + "flash_attention_stream_fwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:668",
         "launches": sum(k3_paths.values()), "launches_by_path": k3_paths, **res[7]},
        {"name": "flash_attention_stream_bwd", "route": "cuda",
         "source": pkg + "flash_attention_stream_bwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:744",
         "launches": sum(k4_paths.values()), "launches_by_path": k4_paths, **res[8]},
        {"name": "dropout", "route": "cuda", "source": pkg + "dropout.cu",
         "replaces": "uncertainty_vit_tpu/ops/dropout.py:43",
         "launches": sum(k8_paths.values()), "launches_by_path": k8_paths, **res[5]},
        {"name": "quant_fwd", "route": "cuda", "source": pkg + "quant_fwd.cu",
         "replaces": "uncertainty_vit_tpu/ops/quant.py:128",
         "launches": sum(k6_paths.values()), "launches_by_path": k6_paths, **res[10]},
        {"name": "quant_wgrad", "route": "cuda", "source": pkg + "quant_wgrad.cu",
         "replaces": "uncertainty_vit_tpu/ops/quant.py:216",
         "launches": sum(k7_paths.values()), "launches_by_path": k7_paths, **res[11]},
        {"name": "flash_attention_cross", "route": "cuda",
         "source": pkg + "flash_attention_stream_fwd.cu",
         "sources": [pkg + "flash_attention_stream_fwd.cu", pkg + "flash_attention_stream_bwd.cu"],
         "replaces": "uncertainty_vit_tpu/ops/flash_attention.py:1136",
         "launches": sum(k5_paths.values()), "launches_by_path": k5_paths,
         "launches_by_kernel": {**{f"seq2_large_{path}": n for path, n in seq2.items()},
                                **{path: {k: n[k] for k in ("K5", "K5_bwd")}
                                   for path, n in seq7c.items()}}, **res[14]},
    ]
    for kern, key in ((kernels[0], "K1"), (kernels[1], "K2"), (kernels[7], "K5")):
        kern["launches_by_path"].update(mesh_k[key])
    # and phase 25's ("cli15_seq2_": slice 15 over two ranks, summed over
    # them; "cli15_": the same runs in one process)
    kernels[7]["launches_by_path"].update({p: n["K5"] + n["K5_bwd"] for p, n in cli15.items()
                                           if n["K5"]})
    kernels[7]["launches_by_kernel"].update({p: {k: n[k] for k in ("K5", "K5_bwd")}
                                             for p, n in cli15.items() if n["K5"]})
    for kern, key in ((kernels[0], "K1"), (kernels[2], "K3"), (kernels[3], "K4"),
                      (kernels[4], "K8")):
        kern["launches_by_path"].update({p: n[key] for p, n in cli15.items() if n[key]})
        kern["launches"] = sum(kern["launches_by_path"].values())
    # phase 13's ViT-H paths ("huge_", "cli14_huge_"), and each attention
    # kernel's numbers at head width 80 ("d80": phases 1, 3, 7, 8 and 14 at
    # D = 80, H = 16)
    for kern, key in ((kernels[0], "K1"), (kernels[1], "K2"), (kernels[2], "K3"),
                      (kernels[3], "K4"), (kernels[7], "K5")):
        kern["launches_by_path"].update({p: n[key] for p, n in huge.items() if n[key]})
        kern["launches"] = sum(kern["launches_by_path"].values())
        kern["d80"] = d80[key]
    # and phase 26's ("large_int8_", "huge_int8_": the int8 trunk of ViT-L/16
    # 512 and ViT-H/16 224; "cli16_": the driver's int8 runs at those presets,
    # the int8 step at ViT-B/16 384 in one process and over two ranks (summed),
    # the golden-weights tool)
    for kern, keys in ((kernels[0], ("K1",)), (kernels[1], ("K2",)), (kernels[2], ("K3",)),
                       (kernels[3], ("K4",)), (kernels[5], ("K6",)), (kernels[6], ("K7",)),
                       (kernels[7], ("K5", "K5_bwd"))):
        kern["launches_by_path"].update({p: sum(n[k] for k in keys) for p, n in cli16.items()
                                         if any(n[k] for k in keys)})
        kern["launches"] = sum(kern["launches_by_path"].values())
    # and phase 27's ("cli17_": the driver's --eval from a converted .pth over
    # 1024 images, the golden's forward), which launch K1 alone
    kernels[0]["launches_by_path"].update({p: n["K1"] for p, n in cli17.items()})
    kernels[0]["launches"] = sum(kernels[0]["launches_by_path"].values())
    # and phase 28's ("cli18_mesh_": slice 18 on the data 2 x seq 2 mesh, summed
    # over the four ranks; "cli18_one_": the same runs in one process)
    for kern, keys in ((kernels[2], ("K3",)), (kernels[3], ("K4",)), (kernels[4], ("K8",)),
                       (kernels[7], ("K5", "K5_bwd"))):
        kern["launches_by_path"].update({p: sum(n[k] for k in keys) for p, n in cli18.items()
                                         if any(n[k] for k in keys)})
        kern["launches"] = sum(kern["launches_by_path"].values())
    kernels[7]["launches_by_kernel"].update({p: {k: n[k] for k in ("K5", "K5_bwd")}
                                             for p, n in cli18.items() if n["K5"]})
    # and phase 29's ("cli19_mesh_": slice 19 on the (2, 2, 1) mesh and its data
    # pairs, summed over the four ranks; "cli19_one_": the same runs in one
    # process), and K1's and K6's times through the fold and the image offset
    for kern, keys in ((kernels[0], ("K1",)), (kernels[1], ("K2",)), (kernels[2], ("K3",)),
                       (kernels[3], ("K4",)), (kernels[4], ("K8",)), (kernels[5], ("K6",)),
                       (kernels[6], ("K7",)), (kernels[7], ("K5", "K5_bwd"))):
        kern["launches_by_path"].update({p: sum(n[k] for k in keys) for p, n in cli19.items()
                                         if any(n[k] for k in keys)})
        kern["launches"] = sum(kern["launches_by_path"].values())
    kernels[7]["launches_by_kernel"].update({p: {k: n[k] for k in ("K5", "K5_bwd")}
                                             for p, n in cli19.items() if n["K5"]})
    kernels[0].update(dropout_fold_ms=fold_times["k1_fold_ms"],
                      dropout_flat_ms=fold_times["k1_flat_ms"])
    kernels[5].update(dgrad_offset_ms=fold_times["k6_offset_ms"],
                      dgrad_flat_ms=fold_times["k6_flat_ms"])
    # and phase 30's ("<b|l><res>_<H>x<D>_": the models with other head widths),
    # and each attention kernel's numbers at those widths ("by_head_dim")
    for kern, key in ((kernels[0], "K1"), (kernels[1], "K2"), (kernels[2], "K3"),
                      (kernels[3], "K4"), (kernels[7], "K5")):
        kern["launches_by_path"].update({p: n[key] for p, n in width_paths.items() if n[key]})
        kern["launches"] = sum(kern["launches_by_path"].values())
        kern["by_head_dim"] = widths[key]
    for kern in kernels:
        check(kern["launches"] > 0, f"{kern['name']} was launched no time on the main paths")
    print(f"chip_smoke: every phase held; {time.perf_counter() - t_start:.1f} s in all, the "
          "kernels' build included", flush=True)
    print(smi.stdout.strip(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
