#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (reagent_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: require CUDA, print the card's name and power limit;
  2. build the CUDA kernels from reagent_tpu_torch/ops/csrc (nvcc, sm_90a);
  3. K1 (offline fused DQN update) against its plain PyTorch version at full
     width, double-Q and single-Q, 5 lockstep updates;
  4. K2 (fused DQN update, one launch per update) the same, at the CartPole
     sample config's shapes, and at the full offline width, which exceeds a
     block's shared memory and takes K2's launch sequence; each route's
     CUDA kernels per update checked (1; 3L + 1 = 10 on the sequence);
  5. CUDA-event timing of each kernel (K2 on both routes) and its plain
     version, beside the bound and K1's products through torch.matmul (a
     yardstick only), and each update's device time by CUDA kernel
     (torch.profiler);
  6. the offline workflow (identify_and_train_network) at full width through
     K1 (8 updates: 8,192 rows, 4 epochs), with the exported artifact scored
     against the in-process module and the host's batch preprocessing timed
     beside the train step;
  7. the workflow at the sample config's shapes through K2;
  8. K2's packed interface (one launch), K3 (fused MLP forward) and K4
     (n-step replay rewards) against their plain versions at the online
     path's shapes;
  9. CUDA-event timing of those three and their plain versions, beside the
     bound and the queued launch floor (an empty kernel's time), K2's, K3's
     and K4's wrapper host time per call at the main path's shapes, K3's
     forward as one torch.addmm per layer (a yardstick only) and K2-packed's
     device time by CUDA kernel;
 10. the fused online DQN loop at bench.py's width (CartPole, 4-128-64-2,
     minibatch 512, packed replay of 100,000): prefill 1,000, a 32-step
     lockstep check against the plain versions on the CPU, then 1,500 steps
     through K2-packed and K3;
 11. the generic online loop (ReplayBuffer of 50,000, softmax acting through
     the K3 scorer, tensor K2, K4 in every sample) for 500 steps, then
     evaluate_policy over 20 greedy episodes through K3;
 12. K5 (pairwise quantile-Huber loss) against its plain versions at
     [4096, 51], [8192, 201], [512, 11], in bfloat16 and on inputs built to
     hit ties: each route of the forward (loss only; loss and gradient
     sums), the backward kernel that scales the sums, and the two under
     autograd;
 13. CUDA-event timing of K5's two forward routes, its backward and the
     trainer's pair (forward with sums, then backward), and of the plain
     versions, at the three shapes, beside the bound;
 14. the offline QR-DQN workflow at full width (D=128, 512, 256, A=8, 51
     atoms, minibatch 4096, 8 updates as phase 6) through K5, the artifact
     scored against the
     in-process module and against the trainer's q_values (K3), and a train
     step's time by CUDA kernel and host operator (torch.profiler);
 15. 5 QR-DQN train steps at that width on the card (K5) against 5 on the
     CPU (the plain version) from one state and the same batches;
 16. the online QR-DQN loop (dueling 64, 64 with 11 atoms, ReplayBuffer of
     50,000, minibatch 512) for 300 steps through K4 and K5, then
     evaluate_policy over 20 greedy episodes and a profiled window;
 17. K1 with its bfloat16 options against its plain version at full width,
     double-Q and single-Q, 5 updates each compared from one state, for
     (matmul, save) = (bf16, bf16) and (f32, bf16), each update's CUDA
     kernels counted (3L + 2 with bf16 products, 3L + 1 without);
 18. CUDA-event timing of K1-bf16, the f32 K1 and the plain bf16 version,
     beside the bound at the tensor cores' bf16 rate and K1-bf16's products
     through torch.matmul on bf16 operands (a yardstick only);
 19. the device-resident fused loop at bench.py's width: a 100,000-row table
     on the card, FusedDQNTrainer(minibatch 4096, block 1024, matmul_dtype
     bfloat16), make_packed_sampled_train_fn for 200 and 1,000 steps, a
     profiled window (device time by CUDA kernel, idle share, host reads),
     then its f32 twin, 5 steps on the card against 5 on the CPU from one
     state and the same indices, and q_values on 64 rows through K3;
 20. the unfused scan path: make_sampled_train_fn(DQNTrainer, ...) on the
     same table with compute_dtype float32 and bfloat16, 200 steps each;
 21. K3 against its plain version at the evaluation's shapes, a batch of
     512 rows of the sample config's net (resident route) and 4,096 rows of
     the full-width net (streamed), and at q_values' 64 rows of it
     (streamed), timed beside one torch.addmm per layer (a yardstick only)
     and the bound; every K3 row (here and in later phases) counts the CUDA
     kernels of one call with torch.profiler: 1 on the resident route, one a
     layer on the streamed route (the script fails otherwise);
 22. the flagship sample config unchanged (4->128->64->2 leaky_relu,
     minibatch 512, Adam lr 0.01, gamma 0.99, tau 0.2, double-Q, CPE on, 20
     epochs, 90/10 split) through identify_and_train_network on a 4,096-row
     table with uniform(0, 1) rewards: the unfused DQNTrainer with its
     reward and CPE Q heads, then the eval split's page through K3 (three
     launches a batch) and DM, IPS, DR, seq-DR, WDR and MAGIC on the card;
     train steps/s, eval_seconds and the evaluation taken apart (host
     decode, the forwards, the page, each estimator), the estimates;
 23. the same at the full offline width (D=128, 512, 256, A=8, CPE heads
     as wide, minibatch 4096, 8,192 rows, 4 epochs);
 24. CPE card against CPU: 5 train steps with the CPE heads at full width
     from one state on the same batches, then the page and every estimate
     of phases 22 and 23's trained states on both, np.random seeded alike;
 25. the reference's dqn_cartpole_e2e job through the four functions reagent
     run calls, with the arguments it builds from the sample config and the
     job's overrides: 12,000 random CartPole transitions (gymnasium where it
     imports, else the port's functional CartPole on the host), the timeline
     operator, the sample config unchanged (20 epochs, CPE on) with the
     DiscreteDQNReporter writing to a recording summary writer (its tags
     checked), K3 three launches an eval batch, the artifact against the
     in-process module, device-to-host copies a step with and without the
     reporter (torch.profiler), then 20 greedy episodes of at most 200 steps
     through load_predictor against the 120 bar;
 26. warm start and reward options at full width: identify_and_train_network
     twice through K1 (8 updates a run) with a warm-start checkpoint and
     metric-weighted rewards (the saved step doubles, each run's final state
     restored bit for bit on the card, K1 launched 16 times), then phase
     24's DQNTrainerState with its five CPE fields saved and restored on the
     card;
 27. SAC and TD3 card against CPU: the sample config's SAC trainer (twin Q,
     autotuned temperature, actor and critics 64, 64 leaky_relu, minibatch
     1,024, Adam 1e-3, gamma 0.9, tau 0.5) for 5 train steps and its TD3
     twin for 4 (two delayed actor updates), from one state with the same
     batches and the same explicit noise; every metric and every state
     tensor compared, no K1-K5 launch;
 28. the reference's sac_pendulum_e2e job through the port's reagent run
     and sac_pendulum_offline.yaml (widths, minibatch, optimizers, gamma,
     tau, seed and bar unchanged; num_epochs, num_train_transitions,
     num_eval_episodes and max_steps cut to SAC_JOB_CUT): random Pendulum
     rows (gymnasium where it imports, else the port's functional Pendulum
     on the host), the timeline operator, SAC with the ActorCriticReporter,
     the actor artifact (model_type "actor", actions in [-2, 2], against
     the in-process module), then train steps/s, the host's decode against
     a train step, CUDA kernels a step and the device's idle share (a
     profiled window), device-to-host copies a step with and without the
     reporter, the greedy episodes' seconds and mean reward (the -1000 bar
     printed, not held at the cut depth);
 29. discrete CRR card against CPU: 5 train steps at the online config's
     widths (actor and q1 128, 64 leaky_relu, minibatch 256, gamma 0.99,
     tau 0.2, Adam 3e-3, beta 1) from one state on the same batches, every
     metric and state tensor compared, no K1-K5 launch;
 30. the offline CRR job (tests/test_offline_managers.py's flow): 10,000
     random CartPole transitions, the timeline with a 95/5 split,
     identify_and_train_network with the DiscreteCRR block (64, 64 relu
     actor and twin critics, Adam 3e-3, gamma 0.99, tau 0.1, beta 1) for
     CRR_OFFLINE["epochs"] epochs, the actor artifact against the
     in-process actor (and actor_logits through K3) on 64 raw rows, train
     steps/s, the host's decode, CUDA kernels a step and the idle share, 20
     greedy episodes through load_predictor (the 100 bar read at 20 epochs
     only);
 31. online discrete CRR through the generic loop (ReplayBuffer of 50,000,
     prefill 3,000, minibatch 256, the actor acting through K3, K4 in every
     sample) for CRR_ONLINE["steps"] steps, a profiled window (kernels a
     step, idle share, host reads), evaluate_policy of the actor;
 32. REINFORCE (64, 64 leaky_relu, Adam 5e-3, normalize, subtract_mean)
     and PPO (32, 32 leaky_relu, Adam 1e-3 with weight decay 1e-3, epsilon
     0.2, 1 epoch) on the functional CartPole with episodes padded to 200
     steps: 3 episodes each card against CPU from one noise tape (actions
     and returns exact), then PG_CONFIGS' episodes each: episodes/s, env
     steps/s, K3 launches an episode, a profiled episode (host reads: 0 or
     the script fails), evaluate_policy;
 33. C51 (128, 64 leaky_relu, 51 atoms on 0..200, minibatch 256, Adam
     3e-3, tau 0.2) and parametric DQN and SARSA (a critic 128, 64
     leaky_relu over state and one-hot action, minibatch 512, Adam 1e-3
     with amsgrad, tau 0.1): 5 train steps each at the online configs'
     widths card against CPU from one state, every metric and state tensor
     compared (phase 29's tolerances), no K1-K5 launch;
 34. K3 at those paths' four shapes (C51's act step [1, 4->128->64->102]
     and evaluate_policy [20, 4]; the parametric scorer's tiled rows [2,
     6->128->64->1] and [40, 6]), each on the resident route, and K4 at
     C51's minibatch of 256, against their plain versions and timed beside
     the launch floor and the bound;
 35. online C51, parametric DQN and parametric SARSA through the generic
     loop (ReplayBuffer of 50,000, prefill 1,000, 150 steps each; the
     reference's 3,000 / 10,000 and 15,000 / 20,000 in
     tools/dqn_family_jobs.py), K3 and K4 exactly once a step, a profiled
     window (kernels a step, idle share, host reads: 0 or the script
     fails), evaluate_policy over 20 greedy episodes through K3;
 36. the DiscreteC51DQN (64, 64 relu, 21 atoms, Adam 2e-3) and
     ParametricDQN (64, 64 relu, Adam 3e-3) managers through
     identify_and_train_network on random CartPole tables of 3,000 and
     10,000 transitions for 2 epochs each (the parametric test's 10 cut to
     2): train steps/s, td_loss, the C51 artifact against the in-process
     module and q_values (K3) on 64 raw rows within 1e-4, ParametricDQN's
     default_model "" (no artifact, as in JAX);
 37. every member of the optimizer union the port once refused (RMSprop,
     Adagrad, Lion, Adadelta, Adamax, NAdam, RAdam, Rprop, ASGD,
     SparseAdam, Lamb, Adafactor) and every LR scheduler, 5 steps card
     against CPU at the full offline width's parameters (Adafactor factors
     the wide weights); every parameter and state tensor compared;
 38. FullyConnectedNetwork with batch norm, layer norm, dropout and skip
     connections at the full offline width (D=128, 512, 256, A=8, 4,096
     rows): the forward, the gradient into every parameter (the batch
     norm's trained mean and var included) and the forward with
     training=True and one fed dropout mask, card against CPU; then the
     offline DQN workflow at that width with a batch-norm, dropout net,
     RAdam and CosineAnnealingLR for 8 steps (train steps/s, the artifact
     with the batch norm folded into its layers against the in-process
     module);
 39. the online SAC, TD3 and continuous-CRR trainers (64, 64, minibatch
     256, Adam 3e-3, tau 0.005), 5 train steps each card against CPU from
     one state with explicit noise;
 40. K3 at the continuous act steps ([1, 3->64->64->2] and ->1 tanh) and
     evaluate_policy's [10, 3] against its plain version, the gaussian act
     step and the evaluation timed beside the launch floor, the bound and
     one torch.addmm a layer (the same check and timing as phase 21); then the three online Pendulum
     jobs through the generic loop (prefill 500, 100 steps each;
     PRIORITIZED_JOB on the PrioritizedReplayBuffer): the act
     step's trunk one K3 launch, every sample one K4 launch, a profiled
     window (kernels a step, idle share, host reads: 0 or the script
     fails), evaluate_policy over 10 greedy episodes through K3;
 41. the world-model slice's modules, card against CPU: OpenGridworld and
     PossibleActionsMaskTester, 8 envs x 40 steps from the same actions and
     draws (rewards atol 1e-6, the rest exactly); 5 MDN-RNN train steps (16 hidden, 1 layer, 1
     gaussian) on 256 StringGame episodes of 6 from one state (losses rtol
     1e-4, every parameter and Adam moment rtol 5e-4, atol 5e-5); then
     StateEmbedEnv over those weights, 8 episodes of 6 (atol 1e-5);
 42. K3 at the new jobs' act and eval shapes ([1] and [20] x 18->64->32->2,
     [1] and [20] x 6->64->4, [10] x 24->64->4) and K4 at capacity 20,000,
     B 256 and 4,096, 128, each against its plain version, the two act
     shapes and K4's first timed beside the launch floor and the bound
     (K3_WM_TIMED, K4_WM_TIMED); then the world-model string pipeline
     (tests/test_world_model_string_e2e.py) cut in depth: 512 random
     StringGame episodes, WORLD_MODEL["wm_steps"] MDN-RNN steps (the loss
     must fall), StateEmbedEnv, a prefill of WORLD_MODEL["prefill"] and
     WORLD_MODEL["steps"] DQN steps (18->64->32->2, minibatch 256, a
     ReplayBuffer of 20,000) through the generic loop, K3 and K4 exactly once
     a step, a profiled window (kernels a step, idle share, host reads: 0 or
     the script fails), evaluate_policy over 5 greedy episodes through K3;
 43. the OpenGridworld DQN (6->64->4, gamma 0.95, prefill 500, 300 steps;
     K3 and K4 once a step) and the possible-actions-mask DQN (24->64->4
     relu, random legal actions, 300 steps, an update a step after the
     first 65: K4 once an update, no K3), each with a profiled window and
     evaluate_policy through K3 (the mask job's greedy act masked); the
     full depths are tools/world_model_jobs.py's;
 44. the sparse slice's modules, card against CPU: the changing-arms
     SparseDQN's forward and 5 DQNTrainer steps on changing-arms batches from
     one state (losses rtol 1e-4; parameters and Adam moments rtol 5e-4,
     atol 5e-5); the touched-rows sparse embedding step at 100,000 x 64,
     B 512, L 50 with duplicate ids and padded slots, 5 steps from one state
     (SPARSE_STEP_TOL: the card's index_add_ adds a duplicate id's
     occurrences in an order that is not fixed);
 45. the sparse embedding step at bench.py's size (a 10,000,000 x 64 table,
     B 4,096, L 50, head 256), 50 steps on one batch (the loss must fall):
     steps/s, the table's effective GB/s (3 B L D 4 bytes a step), a
     profiled window (CUDA kernels a step, idle share) and the peak memory;
 46. K3 at the changing-arms act and eval shapes ([1] and [10] x 18->64->6)
     and K4 at capacity 50,000, B 256, against their plain versions, timed
     beside the launch floor and the bound; then the sparse changing-arms
     DQN (tests/test_sparse_models.py:157) cut in depth: a masked-random
     prefill of SPARSE_ARMS_JOB["prefill"], SPARSE_ARMS_JOB["steps"] steps
     of masked softmax acting (the bag concat in torch, the overarch one K3
     launch) and updates (K4 once a sample), a profiled window (0 host
     reads or the script fails), evaluate_policy over 5 greedy masked
     episodes through K3; the full depth is tools/sparse_jobs.py's;
 47. the ranking slice's modules, card against CPU: Seq2Slate at bench.py's
     _S2S width (2 layers, 8 heads, dim 256, feed-forward 512, S = T = 20)
     on 64 rows from one state dict: the greedy slates (identical), the
     logged slates' per-sequence log-probabilities (rtol and atol 1e-5),
     the card's KV-cached decode against its full decode on the decoded
     prefix (per-symbol probabilities within 1e-6, the same argmax), 3 IPS
     steps' metrics (1e-4 relative); slate-Q's item scores through the
     scorer (one K3 launch) and 3 max-Q trainer steps (phase 44's
     tolerances);
 48. Seq2Slate timed: the IPS step at _S2S, B 256, float32 (20 steps) and
     at _S2S_LARGE, B 1,024, bfloat16 (5 steps), and greedy KV-cached
     RANK_MODE at _S2S, B 512 (10 ranks): steps/s and slates/s, CUDA
     kernels and device time a call (a profiled window of 1), the idle
     share and the peak memory;
 49. K3 at the slate-Q act shape ([10, 41->64->64->1], resident) against
     its plain version, timed beside the launch floor and the bound; then
     slate-Q on RecSim (tests/test_slateq_recsim.py) cut to SLATE_Q_CUT: K3
     launched exactly once an act step and nothing else, env steps/s and a
     profiled episode (kernels and device time an env step, the idle share,
     the host reads of the done flag); the full depth is
     tools/ranking_jobs.py's;
 50. the model-based slice's modules at the jobs' widths, card against CPU:
     3 Seq2Reward steps (64 hidden x 2, step classifier 64, multi_steps 6, B
     256 CartPole windows) and 2 compress-model steps from one state; CEM's
     returns over 2 sampled LinDyna members (100 hidden x 2, population 100,
     horizon 4) and in CartPole's expected mode (horizon 10) from the same
     draws, each plan's choice outside near-ties; the six synthetic-reward
     nets at their builders' widths and 3 RewardNetTrainer steps; the serving
     wrappers (K3 once on the card for the compress model, the binary
     difference scorer, the short-sequence planner's step model and the
     single-step synthetic reward) and the world-model evaluators;
 51. K3 at those serving shapes ([10, 4->64->64->2], [64, 4->64->64->6],
     [10, 6->64->32->1]) against its plain version, timed beside one
     torch.addmm a layer and the bound; the CEM plan at CartPole's
     population 100 and horizon 10 and LinDyna's 10 iterations (ms a plan,
     CUDA kernels, the idle share, host reads), the Seq2Reward and compress
     steps at B 1,024 (steps/s, kernels, the idle share);
 52. the CEM jobs (tests/test_world_models.py:225-404: LinDyna with 1 and 2
     world models, CartPole) and the Seq2Reward job
     (reagent_tpu_torch/gym/model_based.py) cut to MB_CUT's depths: no kernel
     in the CEM jobs, K3 once a greedy step of the compress model and once
     for the step model; the bars are tools/model_based_jobs.py's, at full
     depth;
 53. the bandit slice's modules, card against CPU from one state and the
     same draws: the LinUCB update, coefficients and scores at D 500, the
     disjoint update (10 arms), 10 deep-represent steps, every MAB
     algorithm's scores and choice, the replay evaluator's sums over 20
     batches, and the dynamic LinUCB run's actions at DynamicBanditEnv's
     defaults in lockstep (equal outside near-ties of the top two UCB
     scores);
 54. K3 at the deep-represent score shapes ([1024, 6->16->4], [128,
     6->16->4]) against its plain version, timed beside one torch.addmm a
     layer, the bound and the launch floor; the LinUCB step at D 500 split
     into score, update and coefficients, the pinv alone; the deep-represent
     train step and score, the MAB loop (steps/s, CUDA kernels, the idle
     share, host reads);
 55. the four bandit jobs of tools/cb_jobs.py cut to CB_CUT's depths
     (dynamic LinUCB at 500 features, the replay evaluation, the
     deep-represent job with K3 once a greedy score, the MAB bandits and
     compare_bandit_algos); the bars are the tool's, at full depth;
 56. the off-policy-estimation slice card against CPU: NNTrainer 20
     iterations at 500 x 2, B 1,024 from one seed (the losses, the
     parameters, the predictions, the LR), the MSLR slate job's
     estimates, NeuralDualDICE 20 steps from one init and one
     set of indices (the estimate, the nets), the CartPole harness from one
     tape of draws (the actions equal outside near-ties, the states on the
     valid steps, IPS, DR, MAGIC and the ground truth);
 57. K3 at the OPE shapes, taken from the jobs' inputs (NNTrainer's predict
     [4000, 8->500->500->1] and [32, 10->500->500->1] on the MSLR sample,
     streamed; the CartPole harness's act [200, 4->128->64->2] and Q scoring
     [20000, 4->128->64->2]; DualDICE's zeta over the logs' valid steps,
     [3600, 6->64->64->4]) against
     its plain version and one torch.addmm a layer, timed beside the bound
     and the launch floor; NNTrainer's train steps/s at its defaults, a
     DualDICE step and a CartPole rollout (wall, CUDA kernels, the idle
     share, 0 host reads or the script fails);
 58. the OPE jobs of tools/ope_jobs.py cut to OPE_CUT's depths (the
     CartPole harness, DualDICE on the gridworld, the slate benchmark with
     NNTrainer as the target ranker on the synthetic corpus and the MSLR
     sample), K3 counted on each; the bars are the tool's, at full depth;
 60. the imitation and counterfactual-evaluation slice card against CPU at
     the full offline width (B 4,096): 5 steps each of behavioural cloning
     and the IPS-weighted bandit reward net (FullyConnectedDQN
     128->512->256->8) and of Bayes by backprop (136->512->1, one weight
     noise a step drawn on the CPU) from one state on the same batches
     (losses rtol 1e-4, atol 1e-6; parameters and moments rtol 5e-4, atol
     5e-5), then 5 OneMaxEvolutionPool iterations (population 1,000 over
     9,026 parameters) from one parent and the same mutations; no K1-K5
     launch;
 61. K3 on the imitator gate ([4,096, 128->512->256->8], one launch, its
     mask equal to the plain version's away from the threshold) and on each
     of Bayes by backprop's 32 samples ([4,096, 136->512->1], 32 launches,
     each sample and the mean and population std held to the plain version
     at 1e-5), each timed beside one torch.addmm a layer, the launch floor
     and the bound; the three trainers' train steps/s; the ES pool's
     iterations/s, CUDA kernels, idle share and host reads (the std guard's
     one, or the script fails);
 62. the parallel package at world size 1 on a one-rank NCCL group in a
     temporary file store: the DP step of DQNTrainer with its CPE heads at
     the full width (5 steps), the MP step of the changing-arms SparseDQN on
     a 1 x 1 (data, model) mesh (5 steps) and 3 EsWorker epochs, each equal
     (torch.equal) to its plain step; measure_scaling_efficiency at world
     size 1 (one card measures no scaling);
 63. the leaf utilities card against CPU from one state and one set of
     draws: random search, Q-learning and the MLP ensemble 2 steps of 128
     (numpy streams), policy gradient and Gumbel-softmax 10 steps (samples equal,
     logits rtol 1e-5), Bayes by backprop at its defaults 3 steps (K3 on
     the card; predictions 1e-5, the order outside near-ties, parameters
     rtol 5e-4 atol 5e-5; on a near-tie the card takes the CPU's chosen
     set and goes on), FrechetSort at [1,024, 20] (the same
     permutations, log-probs rtol 1e-5);
 64. K3 at the Bayes-by-backprop surrogate's [2048, 128->32->1] relu against
     its plain version, timed beside one torch.addmm a layer and the bound;
     5 optimize steps of BayesianByBackpropOptimizer at its defaults (one
     K3 launch each; ms a step, CUDA kernels, idle share, host reads and
     Memcpy DtoH);
     StepTimer over 20 K2 updates and a trace naming the K2 kernel;
     grid_search over 2 learning rates x 2 seeds, each 100 K2 updates;
 65. the C++ decision service (serving/, g++ into
     reagent_tpu_torch/_build/serving/ in phase 2, beside nvcc) scores
     phases 6 and 7's artifacts through plans of the port's DSL:
     every action's Q on 64 raw rows within 1e-4 of max(1, |Q|) of the
     in-process serving module on the card;
 59. printed last, after phase 65: one JSON line describing each ported
     kernel (K1's rows with the CUDA
     kernels per update, the products' yardstick and the kernel's own GEMM
     time; K2's rows with the CUDA kernels per update of each route and the
     wrapper's host time; K3's and K4's with the wrapper's host time, the
     launch floor and their other shapes, K3's with its torch.addmm
     yardstick and the evaluation's two shapes, K3's and K4's with their
     share of a step on the discrete-actor, C51, parametric, continuous,
     world-model, gridworld, mask, sparse changing-arms and (K3) slate-Q
     paths, K3's continuous, world-model, changing-arms and slate-Q shapes
     with their torch.addmm yardstick and K4's world-model and changing-arms
     shapes, the deep-represent score's and the OPE shapes), after one line
     of phase 48's Seq2Slate numbers, one of phases 50-52's model-based
     numbers, one of phases 53-55's bandit numbers, one of phases 56-58's
     OPE numbers, one of phases 60-62's numbers and one of phases 63-65's;
     K3's rows add the imitator gate's, the Bayes-by-backprop sample's and
     the Bayes-by-backprop optimizer's surrogate's shapes and launches, K2's
     the StepTimer's and the grid search's launches; K3's row names both
     routes, each with its kernel and the shapes that took it;
 66. (before that line) the CUDA kernels a call of every K3 row of phases
     21-64, counted with torch.profiler in a fresh process of this script
     (--k3-kernels-a-call): 1 on the resident route, one a layer on the
     streamed route, or the script fails.
Each phase's heading carries the seconds since the script started.
Every path runs with the launch counts set to 0 just before it and read
just after; a path whose kernels did not launch once per step fails.
The last line is {"ok": true, "device": {...}}.  It needs no network, and it
imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

DEVICE = "cuda"

# Published peaks (NVIDIA data sheets): f32 outside the tensor cores, HBM
# rate, dense bf16 on the tensor cores.
PEAKS = {
    "H100 PCIe": (51e12, 2.0e12, 756e12),
    "H100": (67e12, 3.35e12, 989e12),  # SXM
}

FULL = dict(D=128, widths=[512, 256], A=8, B=4096, block=512, act="leaky_relu",
            gamma=0.99, tau=0.1, lr=1e-3)
CARTPOLE = dict(D=4, widths=[128, 64], A=2, B=512, block=None, act="leaky_relu",
                gamma=0.99, tau=0.2, lr=0.01)
# K2 at the full offline width: both nets' weights (1.6 MB) exceed a block's
# shared memory, so K2 takes its launch sequence instead of the one launch
K2_LARGE = dict(FULL, B=512, block=None)
# K1 at the DQN benchmark cell's batch (portbench/traffic/table10m_b16384.json):
# its products take other tiles, and walk several split-K chunks a block
K1_CELL = dict(FULL, B=16384, block=1024)
ONE_LAUNCH = {True: 1, False: 1}       # CUDA kernels per K2 update, by double_q


def launch_sequence(n_layers, bf16_products=False):
    """CUDA kernels of one update on the launch sequence (K1, and K2 beyond
    a block's shared memory), double-Q or not: per layer one forward launch
    for every (net, input) pair and one weight-gradient launch (the bias
    gradient in extra blocks), dh past the first layer, the TD rows, one
    Adam, polyak and metrics launch; bf16 products add one launch that
    rounds the weights and observations to bf16 first."""
    return 3 * n_layers + 1 + int(bf16_products)


LAUNCH_SEQUENCE = {dq: launch_sequence(len(FULL["widths"]) + 1) for dq in (True, False)}
# bench.py's online_dqn runs 30,000 steps; cut to fit the time limit
FUSED_STEPS = 1500
GENERIC_STEPS = 500
# tests/test_gym_all_algos.py:98-115 prefills 20,000 and runs 30,000 steps; cut
# to fit the time limit
QR_ONLINE = dict(widths=[64, 64], act="leaky_relu", atoms=11, gamma=0.9, tau=0.05,
                 B=512, prefill=1000, steps=300)
# the offline workflows at full width: 8 updates of 4,096 rows from a table of
# 8,192 rows over 4 epochs (the host's feature identification, which takes
# most of such a phase, grows with the rows)
FULL_ROWS, FULL_EPOCHS = 8192, 4
QR_ATOMS = 51  # QuantileFullyConnected's default num_atoms
QR_OPTIMIZER = {"Adam": {"lr": 0.001, "amsgrad": True}}
K5_SHAPES = [(4096, 51), (8192, 201), (512, 11)]  # offline, the largest named, online
# K5's least FP32 instructions per (i, j) pair.  The loss alone: sub; m =
# min(|td|, kappa) (|td| an operand modifier); the Huber value m (|td| -
# 0.5 m) as an fma and a mul; the sign compare; the weight select; the fma
# into the sum.  With the gradient sums one more fma: clip(td) w = m sw,
# where the select picks the weight with td's sign, sw, and the loss's fma
# takes |sw| as an operand modifier.  Each takes one lane's issue slot, as an
# fma does, so the card issues them at half its peak FLOP/s: 33.5e12 a second
# on an H100 SXM (132 SMs x 128 lanes x 1.98 GHz), 2 FLOPs an instruction.
K5_LOSS_INSTR, K5_SUMS_INSTR = 7, 8
# bench.py:286-321, :395-412: the device-resident offline table and loops
TABLE_ROWS = 100_000
SCAN_BLOCK = 1024
SCAN_STEPS = (200, 1000)  # bench.py's two scan lengths
UNFUSED_STEPS = 200


def log(msg: str) -> None:
    print(msg, flush=True)


_START = time.perf_counter()


def phase(msg: str) -> None:
    """A phase's heading, with the seconds since the script started."""
    log(f"{msg}  [{time.perf_counter() - _START:.1f} s]")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def peaks_for(name: str):
    for key, rates in PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peak rates recorded for {name!r}")


# ------------------------------------------------------------ kernel inputs


def make_inputs(cfg, seed, torch, device):
    """Batch and params8 from a numpy seed: ~20% of next actions impossible,
    ~10% terminals, nonzero Adam moments."""
    rng = np.random.default_rng(seed)
    D, A, B = cfg["D"], cfg["A"], cfg["B"]
    sizes = [D, *cfg["widths"], A]
    dims = list(zip(sizes[:-1], sizes[1:]))
    W = [(rng.normal(size=(o, i)) * np.sqrt(2.0 / i)).astype(np.float32) for i, o in dims]
    b = [(rng.normal(size=(1, o)) * 0.1).astype(np.float32) for _, o in dims]
    Wt = [(w + rng.normal(size=w.shape) * 0.02).astype(np.float32) for w in W]
    bt = [(x + rng.normal(size=x.shape) * 0.02).astype(np.float32) for x in b]
    zeros = [np.zeros_like(p) for p in W + b]
    params8 = W + b + Wt + bt + zeros + zeros
    act = np.eye(A, dtype=np.float32)[rng.integers(0, A, B)]
    mask = (rng.random((B, A)) > 0.2).astype(np.float32)
    mask[np.arange(B), rng.integers(0, A, B)] = 1.0  # at least one possible
    batch = [
        rng.normal(size=(B, D)).astype(np.float32),
        rng.normal(size=(B, D)).astype(np.float32),
        act,
        rng.normal(size=(B, 1)).astype(np.float32),
        (rng.random((B, 1)) > 0.1).astype(np.float32),
        mask,
    ]
    put = lambda a: torch.tensor(a, device=device)
    return dims, [put(x) for x in batch], [put(p) for p in params8]


def step_scalars(torch, step, lr, device, b1=0.9, b2=0.999, eps=1e-8):
    t = torch.tensor(float(step + 1), device=device)
    bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    return (lr * torch.sqrt(bc2) / bc1).float(), (eps * torch.sqrt(bc2)).float()


def kernel_fns(cfg, double_q, dtypes=None):
    """(kernel wrapper, plain version, keyword arguments); ``dtypes`` =
    K1's (matmul_dtype, save_dtype)."""
    from reagent_tpu_torch.ops import fused_dqn, fused_dqn_offline

    acts = [cfg["act"]] * len(cfg["widths"]) + ["linear"]
    kw = dict(activations=acts, gamma=cfg["gamma"], tau=cfg["tau"],
              double_q_learning=double_q)
    if dtypes is not None:
        kw.update(matmul_dtype=dtypes[0], save_dtype=dtypes[1])
    if cfg["block"] is not None:
        kw["block_size"] = cfg["block"]
        return (fused_dqn_offline.fused_dqn_offline_update,
                fused_dqn_offline.fused_dqn_offline_update_reference, kw)
    return fused_dqn.fused_dqn_update, fused_dqn.fused_dqn_update_reference, kw


def compare_kernel(name, cfg, torch, kernels=None):
    """5 lockstep updates of the kernel and its plain version from one state,
    double-Q and single-Q.  Tolerances: float32 sums taken in another order,
    which Adam amplifies where |g| is small (td_loss/metrics rtol 2e-4,
    atol 2e-5; final params rtol 5e-4, atol 5e-5).  ``kernels``: the CUDA
    kernels per update the route must launch, by double_q."""
    worst = 0.0
    for double_q in (True, False):
        kern, plain, kw = kernel_fns(cfg, double_q)
        _, batch, p_kern = make_inputs(cfg, 1234, torch, DEVICE)
        p_plain = [p.clone() for p in p_kern]
        for step in range(5):
            lr_t, eps_t = step_scalars(torch, step, cfg["lr"], DEVICE)
            mk = kern(lr_t, eps_t, *batch, p_kern, **kw)
            if kernels is not None and kern.kernels_per_update != kernels[double_q]:
                raise AssertionError(f"{name} double_q={double_q} launched "
                                     f"{kern.kernels_per_update} CUDA kernels, not {kernels[double_q]}")
            mp = plain(lr_t, eps_t, *batch, p_plain, **kw)
            diff = (mk - mp).abs().max().item()
            rel = ((mk - mp).abs() / mp.abs().clamp_min(1e-30)).max().item()
            log(f"  {name} double_q={double_q} step {step}: metrics "
                f"{mk.flatten().tolist()} max abs {diff:.3e} rel {rel:.3e}")
            torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
            worst = max(worst, diff)
        for i, (a, b) in enumerate(zip(p_kern, p_plain)):
            d = (a - b).abs().max().item()
            r = ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()
            worst = max(worst, d)
            if i % len(cfg["widths"] + [0]) == 0:
                log(f"  {name} double_q={double_q} params8[{i}] {tuple(a.shape)}: "
                    f"max abs {d:.3e} rel {r:.3e}")
            torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)
    return worst


# ------------------------------------------------------------------ timing


def time_ms(torch, fn, warmup=3, iters=20, sleep_cycles=2_000_000_000):
    """Median device time of one call: CUDA events around each call, all
    calls queued behind a GPU sleep so host work does not show as gaps (the
    default ~1 s at H100 clocks outlasts any enqueue here; a few small
    launches need a tenth of it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(sleep_cycles)
    for s, e in events:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def profiled_rows(prof, n):
    """(device rows, host rows) of a profiled window of ``n`` steps, each row
    (us per step, count per step, name), largest first.  Device rows are the
    CUDA kernels and copies themselves: an operator's row repeats the time of
    the kernels it launched, and counting both would count them twice."""
    from torch.autograd import DeviceType

    device_us, cpu_us = [], []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            dev = getattr(ev, "self_device_time_total", None)
            if dev is None:
                dev = getattr(ev, "self_cuda_time_total", 0.0)
            if dev > 0:
                device_us.append((dev / n, ev.count / n, ev.key))
        elif ev.self_cpu_time_total > 0:
            cpu_us.append((ev.self_cpu_time_total / n, ev.count / n, ev.key))
    return sorted(device_us, reverse=True), sorted(cpu_us, reverse=True)


def profile_update(cfg, torch, n=5, dtypes=None):
    """Device time of one update by CUDA kernel (torch.profiler over n
    updates, averaged); returns (total us, us in the GEMM kernels)."""
    kern, _, kw = kernel_fns(cfg, True, dtypes)
    _, batch, params = make_inputs(cfg, 5, torch, "cuda")
    lr_t, eps_t = step_scalars(torch, 0, cfg["lr"], "cuda")
    return profile_calls(torch, lambda: kern(lr_t, eps_t, *batch, params, **kw), n)


def profile_calls(torch, fn, n=5):
    """Device time of one call of ``fn`` by CUDA kernel (torch.profiler over
    n calls, averaged), one row per kernel; returns (total us, us in the
    kernels named *gemm*)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows, _ = profiled_rows(prof, n)
    total = sum(r[0] for r in rows)
    for us, count, key in rows:
        log(f"    {us:9.2f} us  x{count:<5.1f} {key[:90]}")
    gemm = sum(r[0] for r in rows if "gemm" in r[2])
    log(f"    {total:9.2f} us  device time per update (sum of kernels), "
        f"{gemm:.2f} us of it in GEMMs")
    return total, gemm


def roofline(flops, nbytes, name, tensor_cores=False):
    """The larger of the operations over the card's peak (f32 outside the
    tensor cores, or dense bf16 on them) and bytes over its memory rate, in
    ms, and which of the two it is."""
    peak_f32, peak_bw, peak_bf16 = peaks_for(name)
    peak_flops = peak_bf16 if tensor_cores else peak_f32
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def layer_work(cfg, double_q):
    """One update's f32 operations by layer: (fan_in, out, forward FLOPs of
    every (net, input) pair, weight-gradient FLOPs, dh FLOPs), dh past the
    first layer only."""
    B, groups = cfg["B"], 3 if double_q else 2
    sizes = [cfg["D"], *cfg["widths"], cfg["A"]]
    return [(i, o, groups * 2.0 * B * i * o, 2.0 * B * i * o, 2.0 * B * i * o if n else 0.0)
            for n, (i, o) in enumerate(zip(sizes[:-1], sizes[1:]))]


def update_work(cfg, double_q):
    """One update's f32 operations and the parameter count P of one net."""
    layers = layer_work(cfg, double_q)
    flops = sum(fwd + wgrad + dh for _, _, fwd, wgrad, dh in layers)
    return flops, sum(i * o + o for i, o, *_ in layers)


def bound(cfg, double_q, name, tensor_cores=False):
    """Least time for one update: the larger of its matmul operations over
    the card's peak (f32, or bf16 on the tensor cores) and its bytes (inputs
    read once, params8 read and written once, all float32 whatever the
    products' type) over the memory rate."""
    B, D, A = cfg["B"], cfg["D"], cfg["A"]
    flops, P = update_work(cfg, double_q)
    nbytes = 4.0 * (2 * B * D + 2 * B * A + 2 * B + 2 + 2 * 8 * P + 4)
    return (*roofline(flops, nbytes, name, tensor_cores), flops, nbytes)


def time_kernel(cfg, torch, name, dtypes=None):
    kern, plain, kw = kernel_fns(cfg, True, dtypes)
    _, batch, p_kern = make_inputs(cfg, 99, torch, "cuda")
    p_plain = [p.clone() for p in p_kern]
    lr_t, eps_t = step_scalars(torch, 0, cfg["lr"], "cuda")
    ms = time_ms(torch, lambda: kern(lr_t, eps_t, *batch, p_kern, **kw))
    plain_ms = time_ms(torch, lambda: plain(lr_t, eps_t, *batch, p_plain, **kw))
    tensor_cores = dtypes is not None and str(dtypes[0]).endswith("bfloat16")
    b_ms, b_by, flops, nbytes = bound(cfg, True, name, tensor_cores)
    return ms, plain_ms, b_ms, b_by, flops, nbytes


def products_library_ms(cfg, torch, bf16_products=False):
    """A yardstick only, which the port never calls: the products of one
    double-Q K1 update at its shapes as separate torch.matmul calls (cuBLAS):
    per layer three forwards x . W^T, the weight gradient dz^T . h over all
    B rows and, past the first layer, dh = dz . W.  float32 operands (the
    caller turns TF32 off), or bfloat16 ones for K1-bf16.  Median ms of the
    whole set."""
    dt = torch.bfloat16 if bf16_products else torch.float32
    sizes = [cfg["D"], *cfg["widths"], cfg["A"]]
    B = cfg["B"]
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=DEVICE).to(dt)
    xs = [rnd(B, k) for k in sizes[:-1]]
    ws = [rnd(n, k) for k, n in zip(sizes[:-1], sizes[1:])]
    dzs = [rnd(B, n) for n in sizes[1:]]

    def run():
        for i in range(len(ws)):
            for _ in range(3):
                torch.matmul(xs[i], ws[i].t())
        for i in reversed(range(len(ws))):
            torch.matmul(dzs[i].t(), xs[i])
            if i:
                torch.matmul(dzs[i], ws[i])

    return time_ms(torch, run)


# ---------------------------------------------------------------- workflow


def make_table(path, n_rows, n_features, n_actions, seed, rewards="normal", metrics=False):
    """A logged-transition table (the timeline operator's columns) from a
    numpy seed: episodes of 10 steps, so ~10% terminals, and ~20% of the
    next actions impossible.  ``rewards`` "normal" draws N(0, 1), "uniform"
    uniform(0, 1) from the same place in the stream (CPE's normalised
    estimates need a logged policy worth more than 1e-6).  ``metrics`` adds
    a ``metrics`` column of {"ctr": uniform(0, 1), "watch": exponential}
    maps, drawn after every other column."""
    rng = np.random.default_rng(seed)
    import pandas as pd

    ep_len = 10
    states = rng.normal(size=(n_rows + 1, n_features)).astype(np.float32)
    seq = np.arange(n_rows) % ep_len
    terminal = seq == ep_len - 1
    actions = rng.integers(0, n_actions, n_rows + 1)
    names = [str(a) for a in range(n_actions)]

    def feats(row):
        return {i: float(v) for i, v in enumerate(row)}

    possible_next = []
    for r in range(n_rows):
        if terminal[r]:
            possible_next.append([])
            continue
        keep = rng.random(n_actions) > 0.2
        keep[actions[r + 1]] = True
        possible_next.append([n for n, k in zip(names, keep) if k])
    df = pd.DataFrame({
        "mdp_id": [f"ep{r // ep_len}" for r in range(n_rows)],
        "sequence_number": seq,
        "state_features": [feats(states[r]) for r in range(n_rows)],
        "next_state_features": [feats(states[r + 1]) for r in range(n_rows)],
        "action": [names[a] for a in actions[:n_rows]],
        "next_action": [names[a] for a in actions[1:n_rows + 1]],
        "reward": (rng.normal(size=n_rows) if rewards == "normal"
                   else rng.uniform(0.0, 1.0, size=n_rows)).astype(np.float32),
        "not_terminal": (~terminal).astype(np.int64),
        "time_diff": np.ones(n_rows, np.int64),
        "action_probability": np.full(n_rows, 1.0 / n_actions),
        "possible_next_actions": possible_next,
    })
    if metrics:
        ctr, watch = rng.uniform(0.0, 1.0, n_rows), rng.exponential(1.0, n_rows)
        df["metrics"] = [{"ctr": float(c), "watch": float(w)} for c, w in zip(ctr, watch)]
    df.to_pickle(path)
    return df


def run_workflow(cfg, n_rows, epochs, torch, tmp, label, model=None, split=None,
                 rewards="normal"):
    """identify_and_train_network on a synthetic table; returns the output,
    the table, the in-process serving module with the arguments it was built
    from (trainer, trainer state, normalization), the batch preprocessor and
    the wall time.  ``model`` defaults to the fused DiscreteDQN of ``cfg``;
    ``split`` is the table spec's (table_sample, eval_table_sample)."""
    from reagent_tpu_torch.data.data_module import TableSpec
    from reagent_tpu_torch.workflow.training import identify_and_train_network

    table = os.path.join(tmp, f"{label}.pkl")
    df = make_table(table, n_rows, cfg["D"], cfg["A"], seed=7, rewards=rewards)
    model = model or fused_model(cfg)
    with capturing_manager(model) as captured:
        t0 = time.perf_counter()
        out = identify_and_train_network(
            TableSpec(table_name=label, path=table, **table_split(split)), model,
            num_epochs=epochs,
            output_dir=os.path.join(tmp, label), seed=0, device=DEVICE)
        wall = time.perf_counter() - t0
    return (out, df, captured["build_serving_module"], captured["build_serving_module_args"],
            captured["build_batch_preprocessor"], wall)


def fused_model(cfg):
    """The fused DiscreteDQN of ``cfg`` (no CPE heads; K1 with ``block_size``
    where ``cfg`` has a block)."""
    model = {"DiscreteDQN": {
        "trainer_param": {
            "actions": [str(a) for a in range(cfg["A"])],
            "rl": {"gamma": cfg["gamma"], "target_update_rate": cfg["tau"],
                   "maxq_learning": True},
            "double_q_learning": True,
            "minibatch_size": cfg["B"],
            "optimizer": {"Adam": {"lr": cfg["lr"]}},
            "use_fused_kernel": True,
        },
        "net_builder": {"FullyConnected": {
            "sizes": cfg["widths"], "activations": [cfg["act"]] * len(cfg["widths"])}},
        "eval_parameters": {"calc_cpe_in_training": False},
    }}
    if cfg["block"] is not None:
        model["DiscreteDQN"]["trainer_param"]["block_size"] = cfg["block"]
    return model


@contextlib.contextmanager
def capturing_manager(model):
    """Keep what the model manager of ``model`` builds in the block (the
    serving module with its arguments, the batch preprocessor, the
    reporter), to score and time it afterwards."""
    from unittest import mock

    from reagent_tpu_torch.core.registry import MODEL_MANAGERS

    manager_cls = MODEL_MANAGERS.get(next(iter(model)))
    captured = {}

    def capturing(method):
        original = getattr(manager_cls, method)

        def wrapper(self, *args, **kwargs):
            captured[method] = original(self, *args, **kwargs)
            captured[method + "_args"] = args
            return captured[method]
        return mock.patch.object(manager_cls, method, wrapper)

    with capturing("build_serving_module"), capturing("build_batch_preprocessor"), \
            capturing("get_reporter"):
        yield captured


def table_split(split):
    return {} if split is None else dict(zip(("table_sample", "eval_table_sample"), split))


def check_artifact(out, df, serving, torch):
    from reagent_tpu_torch.prediction.predictor_wrapper import DiscreteDqnPredictorWrapper
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense

    path = out.output_paths["default_model"]
    sf = serving.model.preprocessor.sorted_features
    values, presence = sparse_to_dense(df["state_features"].tolist()[:64], sf)
    _, q_artifact = DiscreteDqnPredictorWrapper.load(path)(values, presence)
    _, q_live = serving(torch.tensor(values, device=DEVICE),
                        torch.tensor(presence, device=DEVICE))
    q_live = q_live.cpu().numpy()
    diff = float(np.abs(q_artifact - q_live).max())
    np.testing.assert_allclose(q_artifact, q_live, atol=1e-4, rtol=0)
    assert q_artifact.shape == (64, serving.model.q_network.action_dim)
    assert np.isfinite(q_artifact).all()
    return diff


def counted():
    """(wrapper, plain version) of every kernel, by name."""
    from reagent_tpu_torch.ops import (
        fused_dqn,
        fused_dqn_offline,
        fused_mlp,
        nstep_replay,
        quantile_huber,
    )

    return {
        "quantile_huber_loss": (quantile_huber.quantile_huber_loss,
                                quantile_huber.quantile_huber_loss_reference),
        "fused_dqn_offline_update": (fused_dqn_offline.fused_dqn_offline_update,
                                     fused_dqn_offline.fused_dqn_offline_update_reference),
        "fused_dqn_update": (fused_dqn.fused_dqn_update, fused_dqn.fused_dqn_update_reference),
        "fused_dqn_update_packed": (fused_dqn.fused_dqn_update_packed,
                                    fused_dqn.fused_dqn_update_packed_reference),
        "fused_mlp_forward": (fused_mlp.fused_mlp_forward,
                              fused_mlp.fused_mlp_forward_reference),
        "nstep_rewards": (nstep_replay.nstep_rewards, nstep_replay.nstep_rewards_reference),
    }


def reset_counts():
    """Every kernel's launch count and every plain version's call count to 0."""
    for fn, plain in counted().values():
        fn.launches = 0
        plain.calls = 0
        for extra in ("backward_launches", "sums_launches", "bf16_launches"):
            if hasattr(fn, extra):
                setattr(fn, extra, 0)


def read_counts():
    """(launches by kernel, plain-version calls in all) since reset_counts;
    K5's backward launches under ``quantile_huber_backward`` and its forward
    launches on the gradient route under ``quantile_huber_sums``, and K1's
    launches split into ``fused_dqn_offline_update`` (f32) and
    ``fused_dqn_offline_update_bf16`` (a bfloat16 option set)."""
    pairs = counted()
    launches = {k: fn.launches for k, (fn, _) in pairs.items()}
    launches["quantile_huber_backward"] = pairs["quantile_huber_loss"][0].backward_launches
    launches["quantile_huber_sums"] = pairs["quantile_huber_loss"][0].sums_launches
    k1_bf16 = pairs["fused_dqn_offline_update"][0].bf16_launches
    launches["fused_dqn_offline_update_bf16"] = k1_bf16
    launches["fused_dqn_offline_update"] -= k1_bf16
    return launches, sum(plain.calls for _, plain in pairs.values())


def workflow_phase(cfg, n_rows, epochs, kernel, torch, tmp, label, keep):
    """The workflow of ``cfg`` through ``kernel``; its artifact, first rows
    and in-process module are kept in ``keep`` (a directory and a dict)
    under ``label`` for phase 65."""
    from reagent_tpu_torch.ops import fused_dqn, fused_dqn_offline

    reset_counts()
    out, df, serving, _, batch_pre, wall = run_workflow(cfg, n_rows, epochs, torch, tmp, label)
    launches = {
        "fused_dqn_offline_update": fused_dqn_offline.fused_dqn_offline_update.launches,
        "fused_dqn_update": fused_dqn.fused_dqn_update.launches,
    }
    plain_calls = (fused_dqn.fused_dqn_update_reference.calls
                   + fused_dqn_offline.fused_dqn_offline_update_reference.calls)
    steps = out.logger_data["train_steps"]
    secs = out.logger_data["train_seconds"]
    td = out.training_report.td_loss
    log(f"  {label}: {steps} train steps, launches {launches}, plain-version "
        f"calls {plain_calls}, td_loss {td}, training {secs:.3f} s "
        f"({steps / secs:.2f} steps/s host time included), whole workflow {wall:.1f} s")
    if launches[kernel] != steps or steps == 0:
        raise AssertionError(f"{kernel} launched {launches[kernel]} times for {steps} steps")
    if plain_calls != 0:
        raise AssertionError(f"plain versions ran {plain_calls} times on the main path")
    if td is None or not np.isfinite(td):
        raise AssertionError(f"td_loss is not finite: {td}")
    diff = check_artifact(out, df, serving, torch)
    log(f"  {label}: artifact vs in-process serving module on 64 rows: max abs {diff:.3e}")
    keep_dir, kept = keep
    kept[label] = keep_artifact(out, df, serving, keep_dir, label)
    # where a training step's time goes: the host builds each batch from the
    # logged columns before the one fused update runs on the card
    pre_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch_pre(df.iloc[: cfg["B"]])
        torch.cuda.synchronize()
        pre_s.append(time.perf_counter() - t0)
    log(f"  {label}: batch preprocessing of {cfg['B']} rows on the host: "
        f"{statistics.median(pre_s) * 1e3:.2f} ms (median of 3) of "
        f"{secs / steps * 1e3:.2f} ms per train step")
    return launches[kernel], steps, secs


# ------------------------------------------------------------ online slice

# bench.py:232-254: CartPole (200 steps), 4 -> 128 -> 64 -> 2 leaky_relu,
# gamma 0.99, tau 0.2, Adam lr 0.01, minibatch 512 (the CARTPOLE shapes)
PACKED_COLS = (1, 0, 5, 6)  # CartPole rows: action, observation 1-4, reward, terminal
ROW_WIDTH = 8
EVAL_EPISODES = 20
K4_SHAPES = {"loop": (50_000, 512, 1), "kernel phase": (100_000, 512, 3)}  # capacity, B, H


def example_transition(torch):
    return dict(observation=torch.zeros(4), action=torch.tensor(0, dtype=torch.int32),
                reward=torch.tensor(0.0), terminal=torch.tensor(False))


def copy_state(state, device):
    """A deep copy of one of the port's state dataclasses on ``device``."""
    import dataclasses

    def cp(v):
        if v is None:
            return None
        if dataclasses.is_dataclass(v):
            return copy_state(v, device)
        if isinstance(v, tuple):
            return tuple(cp(x) for x in v)
        if isinstance(v, dict):
            return {k: cp(x) for k, x in v.items()}
        return v.detach().to(device).clone()

    return type(state)(**{f.name: cp(getattr(state, f.name)) for f in dataclasses.fields(state)})


def packed_rows(torch, seed, device):
    """Replay rows of CartPole transitions: ~5% terminals, as on the loop."""
    rng = np.random.default_rng(seed)
    B = CARTPOLE["B"]
    rows = np.zeros((B, ROW_WIDTH), np.float32)
    rows[:, 0] = rng.integers(0, 2, B)
    rows[:, 1:5] = rng.normal(size=(B, 4)) * 0.5
    rows[:, 5] = 1.0
    rows[:, 6] = rng.random(B) < 0.05
    return torch.tensor(rows, device=device)


def k2_packed_kw(double_q):
    cfg = CARTPOLE
    return dict(cols=PACKED_COLS, activations=[cfg["act"]] * 2 + ["linear"],
                gamma=cfg["gamma"], tau=cfg["tau"], double_q_learning=double_q)


def compare_k2_packed(torch):
    """5 lockstep updates of K2's packed interface and its plain version,
    double-Q and single-Q; K2's tolerances (metrics rtol 2e-4, atol 2e-5;
    final params rtol 5e-4, atol 5e-5)."""
    from reagent_tpu_torch.ops import fused_dqn

    worst = 0.0
    for double_q in (True, False):
        kw = k2_packed_kw(double_q)
        _, _, p_kern = make_inputs(CARTPOLE, 1234, torch, DEVICE)
        p_plain = [p.clone() for p in p_kern]
        for step in range(5):
            rows, next_rows = packed_rows(torch, step, DEVICE), packed_rows(torch, 100 + step, DEVICE)
            lr_t, eps_t = step_scalars(torch, step, CARTPOLE["lr"], DEVICE)
            mk = fused_dqn.fused_dqn_update_packed(lr_t, eps_t, rows, next_rows, p_kern, **kw)
            if fused_dqn.fused_dqn_update_packed.kernels_per_update != 1:
                raise AssertionError("K2-packed did not run as one launch: "
                                     f"{fused_dqn.fused_dqn_update_packed.kernels_per_update}")
            mp = fused_dqn.fused_dqn_update_packed_reference(
                lr_t, eps_t, rows, next_rows, p_plain, **kw)
            torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
            worst = max(worst, (mk - mp).abs().max().item())
        for a, b in zip(p_kern, p_plain):
            torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)
            worst = max(worst, (a - b).abs().max().item())
        log(f"  K2-packed double_q={double_q}: 5 updates, last metrics "
            f"{mk.flatten().tolist()}, max abs {worst:.3e}")
    return worst


def k3_inputs(torch, rows, seed):
    """The act step's weights as the trainer passes them (W^T views of
    [out, in] tensors) and ``rows`` CartPole-scale observations."""
    _, _, params = make_inputs(CARTPOLE, seed, torch, DEVICE)
    L = len(CARTPOLE["widths"]) + 1
    weights = [(w.T, b.reshape(-1)) for w, b in zip(params[:L], params[L:2 * L])]
    rng = np.random.default_rng(seed)
    x = torch.tensor((rng.normal(size=(rows, CARTPOLE["D"])) * 0.05).astype(np.float32),
                     device=DEVICE)
    return x, weights, [CARTPOLE["act"]] * (L - 1) + ["linear"]


def compare_k3(torch):
    """The act step ([1, 4]) and evaluate_policy ([20, 4]) of the online
    loops, and the policy-gradient act steps ([1, 4] at PG_CONFIGS' widths);
    float32 sums in another order: rtol 1e-5, atol 1e-5."""
    from reagent_tpu_torch.ops import fused_mlp

    cases = [(f"[{rows}, 4]", *k3_inputs(torch, rows, 5 + rows)) for rows in (1, EVAL_EPISODES)]
    cases += [(f"{name}'s act step [1, 4→{'→'.join(map(str, cfg['widths']))}→2]",
               *k3_eval_inputs(torch, 1, [CARTPOLE["D"], *cfg["widths"], CARTPOLE["A"]], 41))
              for name, cfg in PG_CONFIGS.items()]
    worst = 0.0
    for label, x, weights, acts in cases:
        y = fused_mlp.fused_mlp_forward(x, weights, acts)
        yp = fused_mlp.fused_mlp_forward_reference(x, weights, acts)
        torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
        worst = max(worst, (y - yp).abs().max().item())
        log(f"  K3 {label}: {y[0].tolist()} max abs {(y - yp).abs().max().item():.3e}")
    return worst


def k4_inputs(torch, capacity, B, seed):
    """A store of CartPole-like rewards with ~5% terminals and B uniform
    start indices (some windows wrap the capacity)."""
    rng = np.random.default_rng(seed)
    rewards = torch.tensor(rng.normal(size=capacity).astype(np.float32), device=DEVICE)
    terminals = torch.tensor(rng.random(capacity) < 0.05, device=DEVICE)
    idx = rng.integers(0, capacity, B)
    idx[:4] = [capacity - 1, capacity - 2, capacity - 3, 0]
    return rewards, terminals, torch.tensor(idx, dtype=torch.int64, device=DEVICE)


def compare_k4(torch):
    """The kernel rounds as its plain version does, in its order: exact."""
    from reagent_tpu_torch.ops import nstep_replay

    worst = 0.0
    for label, (capacity, B, H) in K4_SHAPES.items():
        rewards, terminals, idx = k4_inputs(torch, capacity, B, H)
        got = nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99)
        want = nstep_replay.nstep_rewards_reference(rewards, terminals, idx, H, 0.99)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        worst = max(worst, (got[0] - want[0]).abs().max().item())
        log(f"  K4 {label} capacity {capacity} B {B} H {H}: mean steps "
            f"{got[1].float().mean().item():.4f}, terminals {int(got[2].sum())}, exact")
    return worst


def k2_packed_call(torch, seed=99):
    """(K2-packed call, its plain version's call) on one state and batch at
    the online loop's shapes, double-Q."""
    from reagent_tpu_torch.ops import fused_dqn

    kw = k2_packed_kw(True)
    _, _, p_kern = make_inputs(CARTPOLE, seed, torch, DEVICE)
    p_plain = [p.clone() for p in p_kern]
    rows, next_rows = packed_rows(torch, 1, DEVICE), packed_rows(torch, 2, DEVICE)
    lr_t, eps_t = step_scalars(torch, 0, CARTPOLE["lr"], DEVICE)
    return (lambda: fused_dqn.fused_dqn_update_packed(lr_t, eps_t, rows, next_rows, p_kern, **kw),
            lambda: fused_dqn.fused_dqn_update_packed_reference(
                lr_t, eps_t, rows, next_rows, p_plain, **kw))


def time_k2_packed(torch, name):
    """K2-packed's and its plain version's CUDA-event times, the bound and
    its work (the batch is read as the raw [512, 8] rows)."""
    kern, plain = k2_packed_call(torch)
    flops, P = update_work(CARTPOLE, True)
    B = CARTPOLE["B"]
    nbytes = 4.0 * (2 * B * ROW_WIDTH + 2 + 2 * 8 * P + 4)
    return (time_ms(torch, kern), time_ms(torch, plain), *roofline(flops, nbytes, name),
            flops, nbytes, "rows [512, 8], double-Q")


def host_us_per_call(torch, fn, n=200):
    """Host time of one call in us: time.perf_counter over ``n`` calls with no
    sync between them.  With one launch per update, the ctypes wrapper's own
    checks and set-up are most of what an update costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def time_online_kernels(torch, name):
    """CUDA-event times (3 warm-ups, median of 20) of K2-packed, K3 and K4
    and their plain versions at the main path's shapes, with each bound."""
    from reagent_tpu_torch.ops import fused_mlp, nstep_replay

    out = {"K2-packed": time_k2_packed(torch, name)}

    for rows_k3 in (1, EVAL_EPISODES):
        x, weights, acts = k3_inputs(torch, rows_k3, 7)
        sizes = [CARTPOLE["D"], *CARTPOLE["widths"], CARTPOLE["A"]]
        macs = sum(i * o for i, o in zip(sizes[:-1], sizes[1:]))
        flops = 2.0 * rows_k3 * macs
        nbytes = 4.0 * (rows_k3 * sizes[0] + macs + sum(sizes[1:]) + rows_k3 * sizes[-1])
        plain_w = [(w.contiguous(), b) for w, b in weights]  # timed without its copies
        out[f"K3 [{rows_k3}, 4]"] = (
            time_ms(torch, lambda: fused_mlp.fused_mlp_forward(x, weights, acts)),
            time_ms(torch, lambda: fused_mlp.fused_mlp_forward_reference(x, plain_w, acts)),
            *roofline(flops, nbytes, name), flops, nbytes, f"x [{rows_k3}, 4]")

    for label, (capacity, B, H) in K4_SHAPES.items():
        rewards, terminals, idx = k4_inputs(torch, capacity, B, H)
        steps = nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99)[1]
        walked = int(steps.sum())  # this run's windows, as far as each is read
        flops = 2.0 * walked
        nbytes = 8.0 * B + 5.0 * walked + 9.0 * B
        out[f"K4 {label}"] = (
            time_ms(torch, lambda: nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99)),
            time_ms(torch, lambda: nstep_replay.nstep_rewards_reference(
                rewards, terminals, idx, H, 0.99)),
            *roofline(flops, nbytes, name), flops, nbytes,
            f"capacity {capacity}, B {B}, H {H}")
    return out


def k3_products_library_ms(torch, rows=1):
    """A yardstick only, which the port never calls: K3's forward at the act
    step as one torch.addmm per layer and the activation (cuBLAS and
    PyTorch's elementwise kernels), on the same inputs.  Median ms."""
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.ops.fused_dqn import _act

    x, weights, acts = k3_inputs(torch, rows, 7)

    def run():
        h = x
        for (w, b), a in zip(weights, acts):
            h = _act(a, torch.addmm(b, h, w))
        return h

    torch.testing.assert_close(run(), fused_mlp.fused_mlp_forward(x, weights, acts),
                               rtol=1e-5, atol=1e-5)
    return time_ms(torch, run)


def online_host_us(torch):
    """Wrapper host time per call (us) of K3 at the act step ([1, 4]) and at
    evaluate_policy's [20, 4], and of K4 at the loops' shape."""
    from reagent_tpu_torch.ops import fused_mlp, nstep_replay

    out = {}
    for rows in (1, EVAL_EPISODES):
        x, weights, acts = k3_inputs(torch, rows, 7)
        out[f"K3 [{rows}, 4]"] = host_us_per_call(
            torch, lambda: fused_mlp.fused_mlp_forward(x, weights, acts))
    capacity, B, H = K4_SHAPES["loop"]
    rewards, terminals, idx = k4_inputs(torch, capacity, B, H)
    out["K4 loop"] = host_us_per_call(
        torch, lambda: nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99))
    return out


def online_setup(torch, device, seed):
    """The bench's online DQN: env, q-network, trainer and a fresh state."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer

    cfg = CARTPOLE
    env = CartPole(max_steps=200, device=device)
    net = FullyConnectedDQN(state_dim=cfg["D"], action_dim=cfg["A"], sizes=cfg["widths"],
                            activations=[cfg["act"]] * len(cfg["widths"]))
    trainer = FusedDQNTrainer(
        q_network=net, rl=RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"]),
        optimizer={"Adam": {"lr": cfg["lr"]}}, minibatch_size=cfg["B"], device=device)
    return env, net, trainer, trainer.init(torch.Generator().manual_seed(seed))


def fused_loop_against_cpu(torch, env, trainer, tstate, rb, rb_state, n=32):
    """``n`` steps of the fused loop on the card and on the CPU (the plain
    versions) from the same state and noise tape.  Per-step td_loss to rtol
    1e-3, atol 1e-4 and final params to rtol 1e-3, atol 1e-4: each update
    differs at K2's tolerances, and n steps of training feed that back;
    actions and terminals exactly, observations to atol 1e-4 (sin/cos of
    two libraries)."""
    from reagent_tpu_torch.gym.fused_dqn_loop import (
        FusedLoopConfig,
        draw_noise_tape,
        run_fused_loop_from_tape,
    )
    from reagent_tpu_torch.replay import PackedReplayBuffer

    cfg = FusedLoopConfig(num_steps=n, minibatch_size=CARTPOLE["B"])
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    env_state, obs = env.reset(gen)
    tape = draw_noise_tape(env, cfg, gen)
    env_c, _, trainer_c, _ = online_setup(torch, "cpu", 0)
    rb_c = PackedReplayBuffer(replay_capacity=rb.capacity, device="cpu")
    rb_c.init(**example_transition(torch))
    runs = {}
    for dev, e, tr, r in ((DEVICE, env, trainer, rb), ("cpu", env_c, trainer_c, rb_c)):
        runs[dev] = run_fused_loop_from_tape(
            e, tr, copy_state(tstate, dev), r, copy_state(rb_state, dev),
            copy_state(env_state, dev), obs.to(dev).clone(), tuple(x.to(dev) for x in tape), cfg)
    (ts_g, rs_g, aux_g), (ts_c, rs_c, aux_c) = runs[DEVICE], runs["cpu"]
    td_g, td_c = aux_g["td_losses"].cpu(), aux_c["td_losses"]
    torch.testing.assert_close(td_g, td_c, rtol=1e-3, atol=1e-4)
    rows_g, rows_c = rs_g.rows.cpu(), rs_c.rows
    for col in (PACKED_COLS[1], PACKED_COLS[3]):
        assert torch.equal(rows_g[:, col], rows_c[:, col]), f"column {col} differs"
    torch.testing.assert_close(rows_g[:, 1:5], rows_c[:, 1:5], rtol=0, atol=1e-4)
    for a, b in zip(ts_g.params8(), ts_c.params8()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4)
    assert int(aux_g["episodes_completed"]) == int(aux_c["episodes_completed"])
    return (td_g - td_c).abs().max().item()


def fused_loop_phase(torch, steps):
    """Prefill 1,000 random transitions, then ``steps`` of the fused loop
    (bench.py's online_dqn, cut from 30,000 steps to ``steps``)."""
    from reagent_tpu_torch.gym.fused_dqn_loop import FusedLoopConfig, run_fused_online_dqn
    from reagent_tpu_torch.gym.online_loop import prefill_replay_buffer
    from reagent_tpu_torch.replay import PackedReplayBuffer

    env, _, trainer, tstate = online_setup(torch, DEVICE, 0)
    rb = PackedReplayBuffer(replay_capacity=100_000, device=DEVICE)
    rb_state = rb.init(**example_transition(torch))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, 1000)
    assert int(rb_state.add_count) == 1000
    err = fused_loop_against_cpu(torch, env, trainer, tstate, rb, rb_state)
    log(f"  card vs CPU plain versions, 32 lockstep steps: td_loss max abs {err:.3e}")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate, rb_state, aux = run_fused_online_dqn(
        env, trainer, tstate, rb, rb_state, gen,
        FusedLoopConfig(num_steps=steps, minibatch_size=CARTPOLE["B"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    td = aux["td_losses"].cpu()
    episodes = int(aux["episodes_completed"])
    returns = aux["recent_episode_returns"].cpu()
    returns = returns[~torch.isnan(returns)]
    log(f"  fused loop: {steps} env steps + {steps} updates in {wall:.3f} s = "
        f"{steps / wall:.2f} steps/s (each an env step and an update, host time "
        f"included), episodes completed {episodes}, mean of the last "
        f"{len(returns)} returns {returns.mean().item():.2f}, last td_loss "
        f"{td[-1].item():.6g}, launches {launches}, plain-version calls {plain_calls}")
    for kernel in ("fused_dqn_update_packed", "fused_mlp_forward"):
        if launches[kernel] != steps:
            raise AssertionError(f"{kernel} launched {launches[kernel]} times for {steps} steps")
    if plain_calls:
        raise AssertionError(f"plain versions ran {plain_calls} times on the main path")
    if td.shape != (steps,) or not torch.isfinite(td).all() or episodes < 1:
        raise AssertionError(f"fused loop output: td {td.shape}, episodes {episodes}")
    if int(rb_state.add_count) != 1000 + steps or int(tstate.step) != steps:
        raise AssertionError("fused loop did not add and train once per step")

    # where a step's time goes: device time by CUDA kernel over a profiled
    # window, beside the unprofiled wall time per step
    n = 50
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_fused_online_dqn(env, trainer, tstate, rb, rb_state, gen,
                             FusedLoopConfig(num_steps=n, minibatch_size=CARTPOLE["B"]))
        torch.cuda.synchronize()
    device_us, cpu_us = profiled_rows(prof, n)
    dev_step = sum(r[0] for r in device_us)
    wall_step = wall / steps * 1e6
    log(f"  fused loop step: {wall_step:.1f} us wall (unprofiled), {dev_step:.1f} us of "
        f"device kernels (profiled window of {n} steps): the device is idle "
        f"{(1 - dev_step / wall_step) * 100:.1f}% of a step")
    for us, count, key in device_us[:8]:
        log(f"    device {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    for us, count, key in cpu_us[:8]:
        log(f"    host   {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    # a value read back to the host shows as _local_scalar_dense; the one
    # expected is run_fused_online_dqn's prefill guard, before the loop
    counts = {ev.key: ev.count for ev in prof.key_averages()}
    log(f"  host reads of device values in the {n}-step window: "
        f"{counts.get('aten::_local_scalar_dense', 0)} "
        f"(cudaStreamSynchronize: {counts.get('cudaStreamSynchronize', 0)})")
    return launches, steps / wall, err


def generic_loop_phase(torch, steps):
    """ReplayBuffer (capacity 50,000, update_horizon 1) prefilled with 1,000
    random transitions, ``steps`` env steps with softmax acting through the
    K3 scorer and one tensor-K2 update per step, then evaluate_policy over
    20 greedy episodes through K3."""
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import (
        GreedyActionSampler,
        SoftmaxActionSampler,
        discrete_dqn_scorer,
    )
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.replay import ReplayBuffer

    env, net, trainer, tstate = online_setup(torch, DEVICE, 2)
    rb = ReplayBuffer(replay_capacity=50_000, update_horizon=1, gamma=0.99, device=DEVICE)
    rb_state = rb.init(**example_transition(torch))
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, 1000)
    scorer = discrete_dqn_scorer(net)
    softmax, greedy = SoftmaxActionSampler(temperature=1.0), GreedyActionSampler()

    def policy_act(ts, obs, g):
        out = softmax.sample_action(scorer(trainer.mlp_weights(ts), obs[None]), g)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    def greedy_act(ts, obs, g):
        return torch.argmax(greedy.sample_action(scorer(trainer.mlp_weights(ts), obs)).action, -1)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate, rb_state, aux = run_online_training(
        env, trainer, tstate, rb, rb_state, policy_act,
        lambda d: make_discrete_dqn_batch(d, CARTPOLE["A"]), gen,
        OnlineLoopConfig(num_steps=steps, minibatch_size=CARTPOLE["B"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop_launches, plain_calls = read_counts()
    td = aux["td_losses"].cpu()
    log(f"  generic loop: {steps} env steps + {steps} updates in {wall:.3f} s = "
        f"{steps / wall:.2f} steps/s, episodes completed {int(aux['episodes_completed'])}, "
        f"last td_loss {td[-1].item():.6g}, launches {loop_launches}, "
        f"plain-version calls {plain_calls}")
    for kernel in ("nstep_rewards", "fused_mlp_forward", "fused_dqn_update"):
        if loop_launches[kernel] != steps:
            raise AssertionError(f"{kernel} launched {loop_launches[kernel]} times for {steps} steps")
    if plain_calls or td.shape != (steps,) or not torch.isfinite(td).all():
        raise AssertionError(f"generic loop: plain calls {plain_calls}, td {td.shape}")
    if int(rb_state.add_count) != 1000 + steps:
        raise AssertionError("generic loop did not add once per step")

    # the sample the loop trained on, against the same state on the CPU (K4's
    # plain version), for 512 indices the buffer would draw
    idx = rb.sample_index_batch(rb_state, gen, CARTPOLE["B"])
    got = rb.sample(rb_state, indices=idx)
    from reagent_tpu_torch.replay import ReplayBuffer as CpuBuffer

    rb_c = CpuBuffer(replay_capacity=50_000, update_horizon=1, gamma=0.99, device="cpu")
    rb_c.init(**example_transition(torch))
    want = rb_c.sample(copy_state(rb_state, "cpu"), indices=idx.cpu())
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), f"sample[{k}] differs from the CPU buffer"

    reset_counts()
    t0 = time.perf_counter()
    returns = evaluate_policy(env, greedy_act, tstate, gen, num_episodes=EVAL_EPISODES).cpu()
    wall_eval = time.perf_counter() - t0
    eval_launches, plain_calls = read_counts()
    log(f"  evaluate_policy: {EVAL_EPISODES} greedy episodes in {wall_eval:.3f} s, returns "
        f"{returns.tolist()} (mean {returns.mean().item():.2f}), launches {eval_launches}")
    if eval_launches["fused_mlp_forward"] != env.max_steps or plain_calls:
        raise AssertionError(f"evaluate_policy launches {eval_launches}, plain {plain_calls}")
    if returns.shape != (EVAL_EPISODES,) or not ((returns >= 1) & (returns <= env.max_steps)).all():
        raise AssertionError(f"evaluate_policy returns {returns}")
    return loop_launches, eval_launches, steps / wall


# ------------------------------------------------------------ QR-DQN slice


def k5_inputs(torch, B, N, seed, dtype=None, ties=False):
    """Target and current quantiles [B, N] from a numpy seed.  ``ties``:
    quarter-step values (exact in float32), every third target row one value
    (a terminal row's reward) and one current row equal to its target, so td
    lands on 0, on +-0.5 and on +-1.0 = kappa."""
    rng = np.random.default_rng(seed)
    target = rng.normal(size=(B, N)) * 2.0
    current = rng.normal(size=(B, N)) * 2.0
    if ties:
        target, current = np.round(target * 4) / 4, np.round(current * 4) / 4
        target[::3] = 1.0
        current[0] = target[0]
    put = lambda a: torch.tensor(a, dtype=torch.float32, device=DEVICE).to(dtype or torch.float32)
    return put(target), put(current)


def compare_k5(torch):
    """Each K5 kernel against its plain twin, then the two under autograd.

    The forward's loss-only route (under ``torch.no_grad()``) and its
    gradient route give the same per-sample losses bit for bit, within rtol
    1e-5, atol 1e-6 of the plain version (float32 sums in another order,
    with fma contraction); the gradient sums within rtol 1e-5, atol 1e-6 N^2
    (the gradient's bound below, in the sums' units).  The backward kernel
    scales the kernel's own sums within rtol 1e-6 of the plain scaling (a
    division against PyTorch's product with the reciprocal; in bfloat16 one
    more rounding to 8 bits: rtol 1.6e-2, atol 1e-5).  Under autograd the
    gradient of the mean, times B, within rtol 1e-5, atol 1e-6 (bfloat16
    rtol 1.6e-2, atol 1e-5).  Returns the largest float32 abs errors of the
    forward, of the sums route's gradient and of the scaling."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    worst_f = worst_g = worst_s = 0.0
    cases = [(B, N, None, False) for B, N in K5_SHAPES]
    cases += [(4096, 51, torch.bfloat16, False), (4096, 51, None, True)]
    for B, N, dtype, ties in cases:
        target, current = k5_inputs(torch, B, N, seed=B + N, dtype=dtype, ties=ties)
        with torch.no_grad():
            per_loss = qh.quantile_huber_per_sample(target, current.clone().requires_grad_(True))
        per_sums, sums = qh._launch_forward(target, current, 1.0, sums=True)
        weights = torch.linspace(-1.0, 2.0, B, device=DEVICE)
        grad = qh._launch_scale(sums, weights, current.dtype)
        c_kern = current.clone().requires_grad_(True)
        c_plain = current.clone().requires_grad_(True)
        per_kern = qh.quantile_huber_per_sample(target, c_kern, 1.0)
        per_plain = qh.quantile_huber_per_sample_reference(target, c_plain, 1.0)
        (g_kern,) = torch.autograd.grad(per_kern.mean(), c_kern)
        (g_plain,) = torch.autograd.grad(per_plain.mean(), c_plain)
        torch.cuda.synchronize()
        sums_plain = qh.quantile_huber_sums_reference(target, current, 1.0)
        grad_plain = qh.quantile_huber_scale_reference(sums, weights, current.dtype)
        g_kern, g_plain = g_kern.float() * B, g_plain.float() * B
        err_f = (per_kern - per_plain).abs().max().item()
        err_g = (g_kern - g_plain).abs().max().item()
        err_s = (grad.float() - grad_plain.float()).abs().max().item()
        label = f"[{B}, {N}] {'bf16' if dtype else 'f32'}{' ties' if ties else ''}"
        log(f"  K5 {label}: loss {per_kern.mean().item():.6f}, forward max abs {err_f:.3e} "
            f"(loss-only and gradient routes bit for bit: "
            f"{torch.equal(per_loss, per_sums) and torch.equal(per_sums, per_kern)}), sums max "
            f"abs {(sums - sums_plain).abs().max().item():.3e}, scaling max abs {err_s:.3e}, "
            f"gradient (x B) max abs {err_g:.3e} of max |g| {g_plain.abs().max().item():.3e}")
        if not (torch.equal(per_loss, per_sums) and torch.equal(per_sums, per_kern)):
            raise AssertionError(f"K5 {label}: the two forward routes differ")
        torch.testing.assert_close(per_kern, per_plain, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(sums, sums_plain, rtol=1e-5, atol=1e-6 * N * N)
        if dtype is None:
            torch.testing.assert_close(grad, grad_plain, rtol=1e-6, atol=0.0)
            torch.testing.assert_close(g_kern, g_plain, rtol=1e-5, atol=1e-6)
            worst_f, worst_g = max(worst_f, err_f), max(worst_g, err_g)
            worst_s = max(worst_s, err_s)
        else:
            torch.testing.assert_close(grad, grad_plain, rtol=1.6e-2, atol=1e-5)
            torch.testing.assert_close(g_kern, g_plain, rtol=1.6e-2, atol=1e-5)
    return worst_f, worst_g, worst_s


def k5_bounds(B, N, name):
    """K5's bounds in ms at [B, N] float32, each (ms, "operations" or
    "bytes"): the loss-only forward (K5_LOSS_INSTR a pair; target and
    current read, the losses written), the forward with gradient sums
    (K5_SUMS_INSTR a pair; the sums written too), the backward (bytes: the
    sums and the incoming gradient read, the gradient written) and the
    trainer's pair as one function (K5_SUMS_INSTR a pair; target, current and
    the incoming gradient read, the losses and the gradient written)."""
    flops, row = 2.0 * B * N * N, 4.0 * B * N  # an instruction is 2 FLOPs
    return dict(
        loss=roofline(K5_LOSS_INSTR * flops, 2 * row + 4 * B, name),
        sums=roofline(K5_SUMS_INSTR * flops, 3 * row + 4 * B, name),
        bwd=roofline(0, 2 * row + 4 * B, name),
        pair=roofline(K5_SUMS_INSTR * flops, 3 * row + 8 * B, name))


def time_k5(torch, name):
    """CUDA-event times at the three shapes of K5's loss-only forward, its
    forward with gradient sums, its backward and the trainer's pair (the
    forward with sums, then the backward), and of the plain versions of
    each (the pair's: the plain forward and autograd's backward through it),
    with the bounds computed from this run's shapes."""
    from reagent_tpu_torch.ops import quantile_huber as qh

    out = {}
    for B, N in K5_SHAPES:
        target, current = k5_inputs(torch, B, N, seed=N)
        grad_out = torch.full((B,), 1.0 / B, device=DEVICE)
        c_grad = current.clone().requires_grad_(True)
        _, sums = qh._launch_forward(target, current, 1.0, sums=True)

        def pair():
            qh._launch_scale(qh._launch_forward(target, current, 1.0, sums=True)[1],
                             grad_out, current.dtype)

        def plain_fwd_bwd():
            torch.autograd.grad(qh.quantile_huber_loss_reference(target, c_grad), c_grad)

        t = dict(
            loss=time_ms(torch, lambda: qh._launch_forward(target, current, 1.0, sums=False)),
            sums=time_ms(torch, lambda: qh._launch_forward(target, current, 1.0, sums=True)),
            bwd=time_ms(torch, lambda: qh._launch_scale(sums, grad_out, current.dtype)),
            pair=time_ms(torch, pair))
        with torch.no_grad():
            t["plain_loss"] = time_ms(
                torch, lambda: qh.quantile_huber_per_sample_reference(target, current))
            t["plain_sums"] = time_ms(torch, lambda: (
                qh.quantile_huber_per_sample_reference(target, current),
                qh.quantile_huber_sums_reference(target, current, 1.0)))
            t["plain_bwd"] = time_ms(
                torch, lambda: qh.quantile_huber_scale_reference(sums, grad_out, current.dtype))
        t["plain_pair"] = time_ms(torch, plain_fwd_bwd)
        t["bounds"] = k5_bounds(B, N, name)
        t["pairs"] = float(B) * N * N
        out[(B, N)] = t
    return out


def qr_offline_model():
    cfg = FULL
    return {"DiscreteQRDQN": {
        "trainer_param": {
            "actions": [str(a) for a in range(cfg["A"])],
            "rl": {"gamma": 0.9, "target_update_rate": 0.05},
            "double_q_learning": True,
            "minibatch_size": cfg["B"],
            "optimizer": QR_OPTIMIZER,
        },
        "net_builder": {"QuantileFullyConnected": {
            "sizes": cfg["widths"], "activations": [cfg["act"]] * len(cfg["widths"]),
            "num_atoms": QR_ATOMS}},
        "eval_parameters": {"calc_cpe_in_training": False},
    }}


def profile_qr_step(torch, trainer, tstate, batch_pre, df, B, n=5):
    """Where an offline QR-DQN train step's time goes: the host's batch
    preprocessing of ``B`` logged rows (median of 3), ``n`` train steps on
    one batch by the host clock, and the same steps' device time by CUDA
    kernel and host time by operator (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    pre_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = batch_pre(df.iloc[:B])
        torch.cuda.synchronize()
        pre_s.append(time.perf_counter() - t0)
    state, _ = trainer.train_step(tstate, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        state, _ = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = trainer.train_step(state, batch)
        torch.cuda.synchronize()
    device_us, cpu_us = profiled_rows(prof, n)
    dev_step = sum(r[0] for r in device_us)
    k5_us = sum(us for us, _, key in device_us if "quantile_huber" in key)
    gemm_us = sum(us for us, _, key in device_us if "gemm" in key.lower())
    log(f"  QR-DQN train step at B={B}: batch preprocessing on the host "
        f"{statistics.median(pre_s) * 1e3:.2f} ms (median of 3); train_step {step_ms:.3f} ms "
        f"by the host clock (mean of {n}, one batch), of which {dev_step / 1e3:.3f} ms are "
        f"device kernels ({sum(r[1] for r in device_us):.0f} launches a step): K5 forward "
        f"and backward {k5_us / 1e3:.4f} ms, matrix products {gemm_us / 1e3:.4f} ms, "
        f"elementwise and reductions {(dev_step - k5_us - gemm_us) / 1e3:.4f} ms")
    for us, count, key in device_us[:8]:
        log(f"    device {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    for us, count, key in cpu_us[:6]:
        log(f"    host   {us:8.2f} us  x{count:<5.1f} {key[:80]}")


def qr_workflow_phase(torch, tmp, k5_step_ms):
    """identify_and_train_network with DiscreteQRDQN at full width: K5 once
    forward and once backward per train step, a finite loss, the loaded
    artifact against the in-process serving module on 64 raw rows (max abs
    1e-4), and the trainer's q_values (K3, then the mean over atoms) against
    the same module."""
    from reagent_tpu_torch.prediction.predictor_wrapper import CategoricalDqnPredictorWrapper
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense

    cfg, label = FULL, "qr_full_width"
    reset_counts()
    out, df, serving, (trainer, tstate, _), batch_pre, wall = run_workflow(
        cfg, FULL_ROWS, FULL_EPOCHS, torch, tmp, label, model=qr_offline_model())
    launches, plain_calls = read_counts()
    steps, secs = out.logger_data["train_steps"], out.logger_data["train_seconds"]
    td = out.training_report.td_loss
    log(f"  {label}: {steps} train steps, launches {launches}, plain-version calls "
        f"{plain_calls}, td_loss {td}, training {secs:.3f} s ({steps / secs:.2f} steps/s "
        f"host time included), whole workflow {wall:.1f} s; K5 forward with sums + backward "
        f"{k5_step_ms:.4f} ms = {k5_step_ms / (secs / steps * 1e3) * 100:.4f}% of a step")
    for kernel in ("quantile_huber_loss", "quantile_huber_sums", "quantile_huber_backward"):
        if launches[kernel] != steps or steps == 0:
            raise AssertionError(f"{kernel} launched {launches[kernel]} times for {steps} steps")
    if plain_calls:
        raise AssertionError(f"plain versions ran {plain_calls} times on the main path")
    if td is None or not np.isfinite(td):
        raise AssertionError(f"td_loss is not finite: {td}")

    sf = serving.preprocessor.sorted_features
    values, presence = sparse_to_dense(df["state_features"].tolist()[:64], sf)
    names, q_artifact = CategoricalDqnPredictorWrapper.load(
        out.output_paths["default_model"])(values, presence)
    v, p = torch.tensor(values, device=DEVICE), torch.tensor(presence, device=DEVICE)
    _, q_live = serving(v, p)
    diff = float(np.abs(q_artifact - q_live.cpu().numpy()).max())
    np.testing.assert_allclose(q_artifact, q_live.cpu().numpy(), atol=1e-4, rtol=0)
    assert q_artifact.shape == (64, cfg["A"]) and np.isfinite(q_artifact).all()
    assert names == [str(a) for a in range(cfg["A"])]
    q_k3 = trainer.q_values(tstate, serving.preprocessor(v, p))
    torch.cuda.synchronize()
    k3_launches = read_counts()[0]["fused_mlp_forward"]
    diff_k3 = (q_k3 - q_live).abs().max().item()
    torch.testing.assert_close(q_k3, q_live, rtol=1e-4, atol=1e-4)
    if k3_launches != 1:
        raise AssertionError(f"q_values launched K3 {k3_launches} times")
    log(f"  {label}: artifact vs in-process serving module on 64 rows: max abs {diff:.3e}; "
        f"trainer.q_values (K3, mean over {QR_ATOMS} atoms) vs the module: max abs {diff_k3:.3e}")
    launches["fused_mlp_forward"] = k3_launches
    profile_qr_step(torch, trainer, tstate, batch_pre, df, cfg["B"])
    return launches, steps, secs


def qr_lockstep_phase(torch, n=5):
    """``n`` QRDQNTrainer steps at the offline width on the card (K5) and on
    the CPU (the plain version) from one initial state and the same batches.
    td_loss per step to rtol 1e-4, atol 1e-5; final parameters, target
    parameters and Adam moments to rtol 1e-3, atol 1e-4: float32 sums in
    another order, which amsgrad amplifies where |g| is small and ``n`` steps
    feed back."""
    import copy

    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.net_builder.quantile_dqn import QuantileFullyConnected
    from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer

    cfg = FULL
    net = QuantileFullyConnected(
        sizes=cfg["widths"], activations=[cfg["act"]] * len(cfg["widths"]),
        num_atoms=QR_ATOMS).build_q_network(None, cfg["A"], state_dim=cfg["D"])
    kw = dict(num_atoms=QR_ATOMS, rl=RLParameters(gamma=0.9, target_update_rate=0.05),
              optimizer=QR_OPTIMIZER)
    trainers = {"cpu": QRDQNTrainer(copy.deepcopy(net), device="cpu", **kw),
                DEVICE: QRDQNTrainer(net, device=DEVICE, **kw)}
    first = trainers[DEVICE].init(torch.Generator().manual_seed(11))
    states = {dev: copy_state(first, dev) for dev in trainers}
    reset_counts()
    worst_td = 0.0
    for step in range(n):
        _, b, _ = make_inputs(cfg, 500 + step, torch, "cpu")
        obs, nobs, action, reward, not_terminal, mask = b
        td = {}
        for dev, trainer in trainers.items():
            batch = rlt.DiscreteDqnInput(
                state=rlt.FeatureData(obs), next_state=rlt.FeatureData(nobs), action=action,
                next_action=action, reward=reward, time_diff=None, step=None,
                not_terminal=not_terminal, possible_actions_mask=torch.ones_like(mask),
                possible_next_actions_mask=mask).to(dev)
            states[dev], m = trainer.train_step(states[dev], batch)
            td[dev] = m["td_loss"].cpu()
        torch.testing.assert_close(td[DEVICE], td["cpu"], rtol=1e-4, atol=1e-5)
        worst_td = max(worst_td, (td[DEVICE] - td["cpu"]).abs().item())
    launches, plain_calls = read_counts()
    k5 = [launches[k] for k in ("quantile_huber_loss", "quantile_huber_sums",
                                "quantile_huber_backward")]
    if k5 + [plain_calls] != [n] * 4:
        raise AssertionError(f"lockstep: launches {launches}, plain calls {plain_calls}")
    worst_p = 0.0
    g, c = states[DEVICE], states["cpu"]
    for a, b in ((g.q_params, c.q_params), (g.q_target_params, c.q_target_params),
                 (g.opt_state.mu, c.opt_state.mu), (g.opt_state.nu_max, c.opt_state.nu_max)):
        for k in b:
            torch.testing.assert_close(a[k].cpu(), b[k], rtol=1e-3, atol=1e-4)
            worst_p = max(worst_p, (a[k].cpu() - b[k]).abs().max().item())
    log(f"  card (K5) vs CPU (plain version), {n} lockstep train steps: td_loss max abs "
        f"{worst_td:.3e} (last {td[DEVICE].item():.6f}), parameters and moments max abs "
        f"{worst_p:.3e}")
    return worst_td, worst_p


def qr_online_phase(torch):
    """tests/test_gym_all_algos.py:98-115 at the widths given there: QRDQNTrainer
    on a dueling 64, 64 net with 11 atoms, ReplayBuffer of 50,000, softmax
    acting on trainer.q_values, minibatch 512; prefill and steps cut to
    QR_ONLINE's.  Then evaluate_policy over 20 greedy episodes."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.net_builder.quantile_dqn import DuelingQuantile
    from reagent_tpu_torch.replay import ReplayBuffer
    from reagent_tpu_torch.training.qrdqn_trainer import QRDQNTrainer

    q = QR_ONLINE
    steps = q["steps"]
    env = CartPole(max_steps=200, device=DEVICE)
    net = DuelingQuantile(sizes=q["widths"], activations=[q["act"]] * 2,
                          num_atoms=q["atoms"]).build_q_network(None, 2, state_dim=4)
    trainer = QRDQNTrainer(
        net, q["atoms"], rl=RLParameters(gamma=q["gamma"], target_update_rate=q["tau"]),
        optimizer=QR_OPTIMIZER, device=DEVICE)
    tstate = trainer.init(torch.Generator().manual_seed(4))
    rb = ReplayBuffer(replay_capacity=50_000, update_horizon=1, gamma=q["gamma"], device=DEVICE)
    rb_state = rb.init(**example_transition(torch))
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, q["prefill"])
    softmax = SoftmaxActionSampler(temperature=1.0)

    def policy_act(ts, obs, g):
        out = softmax.sample_action(trainer.q_values(ts, obs[None]), g)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    def greedy_act(ts, obs, g):
        return torch.argmax(trainer.q_values(ts, obs), dim=1).to(torch.int32)

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate, rb_state, aux = run_online_training(
        env, trainer, tstate, rb, rb_state, policy_act,
        lambda d: make_discrete_dqn_batch(d, 2), gen,
        OnlineLoopConfig(num_steps=steps, minibatch_size=q["B"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    td = aux["td_losses"].cpu()
    log(f"  online QR-DQN loop: {steps} env steps + {steps} updates in {wall:.3f} s = "
        f"{steps / wall:.2f} steps/s, episodes completed {int(aux['episodes_completed'])}, "
        f"last td_loss {td[-1].item():.6g}, launches {launches}, "
        f"plain-version calls {plain_calls}")
    for kernel in ("nstep_rewards", "quantile_huber_loss", "quantile_huber_sums",
                   "quantile_huber_backward"):
        if launches[kernel] != steps:
            raise AssertionError(f"{kernel} launched {launches[kernel]} times for {steps} steps")
    if plain_calls or td.shape != (steps,) or not torch.isfinite(td).all():
        raise AssertionError(f"online QR-DQN loop: plain calls {plain_calls}, td {td.shape}")
    if int(rb_state.add_count) != q["prefill"] + steps or int(tstate.step) != steps:
        raise AssertionError("online QR-DQN loop did not add and train once per step")

    returns = evaluate_policy(env, greedy_act, tstate, gen, num_episodes=EVAL_EPISODES).cpu()
    log(f"  evaluate_policy: {EVAL_EPISODES} greedy episodes, returns {returns.tolist()} "
        f"(mean {returns.mean().item():.2f})")
    if returns.shape != (EVAL_EPISODES,) or not ((returns >= 1) & (returns <= env.max_steps)).all():
        raise AssertionError(f"evaluate_policy returns {returns}")

    # where a step's time goes: a profiled window beside the unprofiled wall time
    from torch.profiler import ProfilerActivity, profile

    n = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_online_training(
            env, trainer, tstate, rb, rb_state, policy_act,
            lambda d: make_discrete_dqn_batch(d, 2), gen,
            OnlineLoopConfig(num_steps=n, minibatch_size=q["B"]))
        torch.cuda.synchronize()
    device_us, cpu_us = profiled_rows(prof, n)
    dev_step, wall_step = sum(r[0] for r in device_us), wall / steps * 1e6
    k5_us = sum(us for us, _, key in device_us if "quantile_huber" in key)
    log(f"  online QR-DQN step: {wall_step:.1f} us wall (unprofiled), {dev_step:.1f} us of "
        f"device kernels in {sum(r[1] for r in device_us):.0f} launches (profiled window of "
        f"{n} steps), K5 forward and backward {k5_us:.1f} us of them: the device is idle "
        f"{(1 - dev_step / wall_step) * 100:.1f}% of a step")
    for us, count, key in device_us[:6]:
        log(f"    device {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    for us, count, key in cpu_us[:6]:
        log(f"    host   {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    return launches, steps / wall


# ------------------------------------------- device-resident offline slice


def assert_first_moments_close(torch, got, want, label):
    """First moments ``b1 * m + 0.1 * g`` after one update from one state:
    rtol 1e-3, atol 5e-6, except in at most 16 rows of a weight's moment
    (elements of a bias's), where up to 2e-4 is allowed.  Those outliers are
    sign flips, not rounding: a hidden pre-activation within float32 rounding
    of 0 lands on the other side in the other summation order, leaky_relu's
    derivative there is 1 or 0.01, and that batch row's term (about
    0.1 * |dz| * |h_prev|, some 1e-5 at this width) enters one row of dW in
    full or at a hundredth.  Returns (max abs, outliers, rows holding them)."""
    diff = (got - want).abs()
    far = diff > 5e-6 + 1e-3 * want.abs()
    rows = int(far.any(dim=1).sum()) if got.shape[0] > 1 else int(far.sum())
    worst = diff.max().item()
    if rows > 16 or worst > 2e-4:
        raise AssertionError(f"{label}: first moments differ in {rows} rows "
                             f"({int(far.sum())} elements), max abs {worst:.3e}")
    return worst, int(far.sum()), rows


def compare_k1_bf16(torch, dtypes, label):
    """5 updates of K1 with ``dtypes`` = (matmul_dtype, save_dtype), each held
    against its plain version run from the SAME state: before every update
    the plain version is handed a copy of the kernel's state.  Two bfloat16
    trajectories left to themselves part within a few updates without either
    being wrong: both sides multiply bfloat16 values exactly but sum in
    another order, a last-bit difference in a pre-activation flips the
    bfloat16 rounding of a saved activation (2^-8 relative there, a few
    hundred of three million a step), that changes sign(g) for weights
    whose gradient is near 0, and Adam moves those by about lr either way.
    Per update: metrics rtol 2e-4, atol 2e-5; the first moments
    (b1 * m + 0.1 * g, linear in the gradient) as
    assert_first_moments_close says; parameters and targets atol
    2 * 3.2 * lr_t (Adam's largest step, from zero moments, is
    lr_t * 0.1 / sqrt(0.001)) with a mean abs difference under 1e-6.
    Double-Q and single-Q; each update launches launch_sequence(L, bf16 products)
    CUDA kernels.  Returns the largest abs error of the metrics and
    first moments."""
    cfg, worst = FULL, 0.0
    L = len(cfg["widths"]) + 1
    for double_q in (True, False):
        kern, plain, kw = kernel_fns(cfg, double_q, dtypes)
        _, batch, p_kern = make_inputs(cfg, 1234, torch, DEVICE)
        for step in range(5):
            p_plain = [p.clone() for p in p_kern]
            lr_t, eps_t = step_scalars(torch, step, cfg["lr"], DEVICE)
            mk = kern(lr_t, eps_t, *batch, p_kern, **kw)
            want = launch_sequence(L, dtypes[0] == torch.bfloat16)
            if kern.bf16_kernels_per_update != want:
                raise AssertionError(f"{label} launched {kern.bf16_kernels_per_update} CUDA "
                                     f"kernels per update, not {want}")
            mp = plain(lr_t, eps_t, *batch, p_plain, **kw)
            diff = (mk - mp).abs().max().item()
            torch.testing.assert_close(mk, mp, rtol=2e-4, atol=2e-5)
            worst_m = n_far = n_rows = 0
            for i in range(4 * L, 6 * L):
                d, far, rows = assert_first_moments_close(
                    torch, p_kern[i], p_plain[i], f"{label} step {step} params8[{i}]")
                worst_m, n_far, n_rows = max(worst_m, d), n_far + far, n_rows + rows
            far_p = mean_p = 0.0
            for a, b in zip(p_kern[:4 * L], p_plain[:4 * L]):
                torch.testing.assert_close(a, b, rtol=0, atol=2 * 3.2 * lr_t.item())
                far_p = max(far_p, (a - b).abs().max().item())
                mean_p = max(mean_p, (a - b).abs().mean().item())
            log(f"  {label} double_q={double_q} step {step}: metrics {mk.flatten().tolist()} "
                f"max abs {diff:.3e}; first moments max abs {worst_m:.3e} ({n_far} outliers in {n_rows} rows); "
                f"parameters max abs {far_p:.3e}, largest mean abs {mean_p:.3e}")
            if mean_p > 1e-6:
                raise AssertionError(f"{label}: parameters part by {mean_p:.3e} on average")
            worst = max(worst, diff, worst_m)
    return worst


def offline_dataset(torch, device):
    """bench.py:293-318's device-resident training table, drawn in its order
    from numpy.random.default_rng(0): TABLE_ROWS rows of D features, A
    actions, every row non-terminal, every action possible."""
    from reagent_tpu_torch.core import types as rlt

    S, A, N = FULL["D"], FULL["A"], TABLE_ROWS
    g = np.random.default_rng(0)
    put = lambda a: torch.tensor(a, device=device)
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(put(g.normal(size=(N, S)).astype(np.float32))),
        next_state=rlt.FeatureData(put(g.normal(size=(N, S)).astype(np.float32))),
        action=put(np.eye(A, dtype=np.float32)[g.integers(0, A, N)]),
        next_action=put(np.eye(A, dtype=np.float32)[g.integers(0, A, N)]),
        reward=put(g.normal(size=(N, 1)).astype(np.float32)),
        time_diff=put(np.ones((N, 1), np.float32)),
        step=put(np.ones((N, 1), np.int32)),
        not_terminal=put(np.ones((N, 1), np.float32)),
        possible_actions_mask=put(np.ones((N, A), np.float32)),
        possible_next_actions_mask=put(np.ones((N, A), np.float32)),
    )


def offline_net(torch, compute_dtype=None):
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN

    cfg = FULL
    kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    return FullyConnectedDQN(state_dim=cfg["D"], action_dim=cfg["A"], sizes=cfg["widths"],
                             activations=[cfg["act"]] * len(cfg["widths"]), **kw)


def fused_offline_trainer(torch, matmul_dtype, device):
    """bench.py:400-406's trainer."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer

    return FusedDQNTrainer(
        offline_net(torch), RLParameters(gamma=0.99, target_update_rate=0.1),
        optimizer={"Adam": {"lr": 1e-3}}, minibatch_size=FULL["B"], block_size=SCAN_BLOCK,
        matmul_dtype=matmul_dtype, device=device)


def profile_loop(torch, run, n, wall_step_us, label, ported=None):
    """A profiled window of ``n`` steps of ``run()``: device time per step by
    CUDA kernel, launches per step, the gathers' share, the device's idle
    share against the unprofiled wall time per step, and the host reads of
    device values (``aten::_local_scalar_dense``; 0 expected in the loop).
    ``ported``, a dict, receives the device us per step of K3's and K4's
    CUDA kernels (``fused_mlp``, ``nstep``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    device_us, cpu_us = profiled_rows(prof, n)
    dev_step = sum(r[0] for r in device_us)
    launches = sum(r[1] for r in device_us)
    gather_us = sum(us for us, _, key in device_us if "index" in key.lower())
    counts = {ev.key: ev.count for ev in prof.key_averages()}
    reads = counts.get("aten::_local_scalar_dense", 0)
    log(f"  {label} step: {wall_step_us:.1f} us wall (unprofiled), {dev_step:.1f} us of device "
        f"kernels in {launches:.1f} launches (profiled window of {n} steps), gathers "
        f"{gather_us:.1f} us of them: the device is idle "
        f"{(1 - dev_step / wall_step_us) * 100:.1f}% of a step; host reads of device values "
        f"in the window: {reads} (cudaStreamSynchronize: {counts.get('cudaStreamSynchronize', 0)})")
    for us, count, key in device_us[:8]:
        log(f"    device {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    for us, count, key in cpu_us[:5]:
        log(f"    host   {us:8.2f} us  x{count:<5.1f} {key[:80]}")
    if ported is not None:
        for name in ("fused_mlp", "nstep"):
            ported[name] = sum(us for us, _, key in device_us if name in key)
        log(f"    K3 {ported['fused_mlp']:.2f} us, K4 {ported['nstep']:.2f} us of device time a "
            f"step: {ported['fused_mlp'] / wall_step_us * 100:.2f}% and "
            f"{ported['nstep'] / wall_step_us * 100:.2f}% of its wall time")
    if reads:
        raise AssertionError(f"{label}: {reads} host reads of device values inside the loop")
    return dev_step, launches


def td_trend(td):
    """(mean of the first 20 losses, mean of the last 20)."""
    return td[:20].mean().item(), td[-20:].mean().item()


def device_resident_fused_phase(torch, dataset, matmul_dtype, label):
    """bench.py:383-434 on the port: make_packed_sampled_train_fn over the
    table on the card for SCAN_STEPS steps; K1 once per step, no plain
    version, no host read in the loop.  Returns the trainer, its final state,
    the launches by kernel, the steps/s of each scan length and the first
    scan's td_loss per step."""
    trainer = fused_offline_trainer(torch, matmul_dtype, DEVICE)
    state = trainer.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    state, _ = trainer.make_packed_sampled_train_fn(dataset, num_steps=3)(state, gen)  # warm up
    reset_counts()
    rates, tds = {}, []
    for n in SCAN_STEPS:
        run = trainer.make_packed_sampled_train_fn(dataset, num_steps=n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = run(state, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates[n] = n / wall
        td = metrics["td_loss"].cpu()
        if td.shape != (n,) or not torch.isfinite(td).all():
            raise AssertionError(f"{label}: td_loss {td.shape} finite {torch.isfinite(td).all()}")
        tds.append(td)
        del run
    launches, plain_calls = read_counts()
    steps = sum(SCAN_STEPS)
    k1 = counted()["fused_dqn_offline_update"][0]
    if matmul_dtype == torch.bfloat16:
        kernel, per_update = "fused_dqn_offline_update_bf16", k1.bf16_kernels_per_update
    else:
        kernel, per_update = "fused_dqn_offline_update", k1.kernels_per_update
    trends = "; ".join(
        "{} steps: first 20 {:.4f}, last 20 {:.4f}".format(len(td), *td_trend(td)) for td in tds)
    log(f"  {label}: " + ", ".join(f"{n} steps at {r:.2f} steps/s" for n, r in rates.items())
        + f" (host time included, synchronised at the ends only); td_loss over {trends}; "
        f"launches {launches}, plain-version calls {plain_calls}, CUDA kernels per update "
        f"{per_update}")
    other = "fused_dqn_offline_update" if "bf16" in kernel else "fused_dqn_offline_update_bf16"
    if launches[kernel] != steps or launches[other] != 0 or int(state.step) != steps + 3:
        raise AssertionError(f"{label}: {kernel} launched {launches[kernel]} times "
                             f"({other}: {launches[other]}) for {steps} steps")
    if plain_calls:
        raise AssertionError(f"{label}: plain versions ran {plain_calls} times on the main path")
    n = 50
    window = trainer.make_packed_sampled_train_fn(dataset, num_steps=n)
    holder = [state]

    def run_window():
        holder[0], _ = window(holder[0], gen)

    wall_step_us = 1e6 / rates[SCAN_STEPS[-1]]
    profile_loop(torch, run_window, n, wall_step_us, label)
    return trainer, holder[0], launches, rates, tds[0]


def fused_lockstep_against_cpu(torch, dataset, n=5):
    """``n`` train steps of the bf16 trainer on the card (K1 on the tensor
    cores) and on the CPU (the plain version) from one state, on minibatches
    gathered with the same indices (numpy seed).  td_loss per step rtol 1e-3,
    atol 1e-4; first moments after the first step as
    assert_first_moments_close says; final parameters atol 2 * lr per step, mean abs difference under 1e-5
    (compare_k1_bf16 says why)."""
    from reagent_tpu_torch.training import scan_loop

    trainers = {DEVICE: fused_offline_trainer(torch, torch.bfloat16, DEVICE),
                "cpu": fused_offline_trainer(torch, torch.bfloat16, "cpu")}
    first = trainers[DEVICE].init(torch.Generator().manual_seed(3))
    states = {dev: copy_state(first, dev) for dev in trainers}
    rng = np.random.default_rng(17)
    reset_counts()
    worst_td = worst_m = 0.0
    for step in range(n):
        idx = torch.tensor(rng.integers(0, TABLE_ROWS, FULL["B"]), device=DEVICE)
        batch = scan_loop.tree_map(lambda x: x[idx], dataset)
        td = {}
        for dev, trainer in trainers.items():
            states[dev], m = trainer.train_step(states[dev], batch.to(dev))
            td[dev] = m["td_loss"].cpu()
        torch.testing.assert_close(td[DEVICE], td["cpu"], rtol=5e-3, atol=1e-3)
        worst_td = max(worst_td, (td[DEVICE] - td["cpu"]).abs().item())
        if step == 0:
            for a, b in zip(states[DEVICE].mW + states[DEVICE].mb,
                            states["cpu"].mW + states["cpu"].mb):
                worst_m = max(worst_m, assert_first_moments_close(
                    torch, a.cpu(), b, "lockstep first moments")[0])
    launches, plain_calls = read_counts()
    if (launches["fused_dqn_offline_update_bf16"], plain_calls) != (n, n):
        raise AssertionError(f"lockstep: launches {launches}, plain calls {plain_calls}")
    far = mean = 0.0
    g, c = states[DEVICE], states["cpu"]
    for a, b in zip(g.W + g.b + g.Wt + g.bt, c.W + c.b + c.Wt + c.bt):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2 * 1e-3 * n)
        far = max(far, (a.cpu() - b).abs().max().item())
        mean = max(mean, (a.cpu() - b).abs().mean().item())
    log(f"  card (K1-bf16) vs CPU (plain version), {n} lockstep train steps: td_loss max abs "
        f"{worst_td:.3e} (last {td[DEVICE].item():.6f}), first moments after step 1 max abs "
        f"{worst_m:.3e}, parameters max abs {far:.3e}, largest mean abs {mean:.3e}")
    if mean > 1e-4:
        raise AssertionError(f"lockstep: parameters part by {mean:.3e} on average")
    return worst_td


def q_values_phase(torch, trainer, state, dataset):
    """trainer.q_values on 64 table rows (one K3 launch at [64, 128] -> 512
    -> 256 -> 8) against the exported q-network's own forward: float32 sums
    in another order, rtol 1e-4, atol 1e-4."""
    obs = dataset.state.float_features[:64].contiguous()
    reset_counts()
    q = trainer.q_values(state, obs)
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    with torch.no_grad():
        want = trainer.export_q_network(state)(obs)
    diff = (q - want).abs().max().item()
    torch.testing.assert_close(q, want, rtol=1e-4, atol=1e-4)
    if launches["fused_mlp_forward"] != 1 or plain_calls or not torch.isfinite(q).all():
        raise AssertionError(f"q_values: launches {launches}, plain calls {plain_calls}")
    log(f"  q_values (K3) on 64 rows vs the exported q-network: max abs {diff:.3e}, "
        f"q[0] {q[0].tolist()}")
    return launches["fused_mlp_forward"]


def unfused_scan_phase(torch, dataset, compute_dtype, label):
    """bench.py:324-380 on the port: make_sampled_train_fn over a DQNTrainer
    whose net computes in ``compute_dtype``, UNFUSED_STEPS steps on the
    table on the card.  No hand-written kernel is on this path (the matrix
    products are PyTorch's, as the JAX path leaves them to XLA)."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.training import DQNTrainer, make_sampled_train_fn

    trainer = DQNTrainer(
        offline_net(torch, compute_dtype), rl=RLParameters(gamma=0.99, target_update_rate=0.1),
        optimizer={"Adam": {"lr": 1e-3}}, device=DEVICE)
    state = trainer.init(torch.Generator().manual_seed(0))
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    state, _ = make_sampled_train_fn(trainer, dataset, FULL["B"], 3)(state, gen)  # warm up
    run = make_sampled_train_fn(trainer, dataset, FULL["B"], UNFUSED_STEPS)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = run(state, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    td = metrics["td_loss"].float().cpu()
    first, last = td_trend(td)
    rate = UNFUSED_STEPS / wall
    log(f"  {label}: {UNFUSED_STEPS} steps at {rate:.2f} steps/s (host time included, "
        f"synchronised at the ends only); td_loss first 20 {first:.4f}, last 20 {last:.4f}; "
        f"hand-written kernel launches {sum(launches.values())}, plain-version calls {plain_calls}")
    if td.shape != (UNFUSED_STEPS,) or not torch.isfinite(td).all():
        raise AssertionError(f"{label}: td_loss {td.shape}")
    if int(state.step) != UNFUSED_STEPS + 3 or plain_calls:
        raise AssertionError(f"{label}: step {int(state.step)}, plain calls {plain_calls}")
    for p in state.q_params.values():
        if p.dtype != torch.float32 or not torch.isfinite(p).all():
            raise AssertionError(f"{label}: parameters {p.dtype}")
    n = 20
    window = make_sampled_train_fn(trainer, dataset, FULL["B"], n)
    profile_loop(torch, lambda: window(state, gen), n, 1e6 / rate, label)
    return rate, td


def compare_td_paths(torch, tds):
    """The fused and the unfused loops start from the same weights (generator
    seed 0) and draw the same minibatch indices (generator seed 1 on the
    card), so over their first UNFUSED_STEPS steps they are one algorithm in
    four arithmetics.  td_loss per step of each against the fused float32
    loop: the float32 autograd trainer within rtol 1e-2 (float32 sums in
    another order, fed back through 200 Adam steps), the two bfloat16 paths
    within rtol 5e-2 (they round at every product)."""
    base = tds["fused f32"][:UNFUSED_STEPS]
    for label, td in tds.items():
        rel = ((td[:UNFUSED_STEPS] - base).abs() / base.abs()).max().item()
        log(f"  td_loss over the first {UNFUSED_STEPS} steps, {label}: first 20 "
            "{:.4f}, last 20 {:.4f}".format(*td_trend(td[:UNFUSED_STEPS]))
            + f", max rel difference from the fused f32 loop {rel:.3e}")
        limit = 5e-2 if "bf16" in label else 1e-2
        if rel > limit:
            raise AssertionError(f"{label}: td_loss parts from the fused f32 loop by {rel:.3e}")


# --------------------------------------------------------------- CPE slice

# reagent_tpu/workflow/sample_configs/discrete_dqn_cartpole_offline.yaml, the
# parts the run reads, as a dict: the machine with the card has no PyYAML
# (tests/test_torch_cpe_workflow.py holds this equal to the file)
SAMPLE_CONFIG = {
    "table_sample": 90.0,
    "eval_table_sample": 10.0,
    "model": {"DiscreteDQN": {
        "trainer_param": {
            "actions": ["0", "1"],
            "rl": {"gamma": 0.99, "target_update_rate": 0.2, "maxq_learning": True},
            "double_q_learning": True,
            "minibatch_size": 512,
            "optimizer": {"Adam": {"lr": 0.01}},
        },
        "net_builder": {"FullyConnected": {
            "sizes": [128, 64], "activations": ["leaky_relu", "leaky_relu"]}},
        "eval_parameters": {"calc_cpe_in_training": True},
    }},
    "num_epochs": 20,
}
SAMPLE_CPE_ROWS = 4096  # ~410 evaluation rows after the 90/10 split
FULL_CPE_ROWS, FULL_CPE_EPOCHS = 8192, 4  # 4 train steps, ~850 evaluation rows
# K3 at the evaluation's forwards: a batch of the sample config's net (the
# resident route) and a full evaluation batch of the full-width net (streamed);
# and the device-resident loop's FusedDQNTrainer.q_values on 64 rows of the
# full-width net (streamed; phase 19 runs it once);
# label -> (rows, sizes, activations, resident route expected, seed)
K3_EVAL_SHAPES = {
    "[512, 4->128->64->2]": (512, [4, 128, 64, 2], ["leaky_relu"] * 2 + ["linear"], True, 512),
    "[4096, 128->512->256->8]": (4096, [128, 512, 256, 8], ["leaky_relu"] * 2 + ["linear"],
                                 False, 4096),
    "q_values [64, 128->512->256->8]": (64, [128, 512, 256, 8], ["leaky_relu"] * 2 + ["linear"],
                                        False, 64)}


def full_cpe_model():
    """The full offline width (FULL) on the unfused DQNTrainer with CPE on;
    the CPE heads take the q-network's widths."""
    cfg = FULL
    net = {"FullyConnected": {
        "sizes": cfg["widths"], "activations": [cfg["act"]] * len(cfg["widths"])}}
    return {"DiscreteDQN": {
        "trainer_param": {
            "actions": [str(a) for a in range(cfg["A"])],
            "rl": {"gamma": cfg["gamma"], "target_update_rate": cfg["tau"],
                   "maxq_learning": True},
            "double_q_learning": True,
            "minibatch_size": cfg["B"],
            "optimizer": {"Adam": {"lr": cfg["lr"]}},
        },
        "net_builder": net,
        "cpe_net_builder": net,
        "eval_parameters": {"calc_cpe_in_training": True},
    }}


def k3_eval_inputs(torch, rows, sizes, seed):
    """Weights as functional.score passes them (W^T views of [out, in]
    tensors, N(0, 2/fan_in)) and ``rows`` normal observations."""
    rng = np.random.default_rng(seed)
    weights = []
    for i, o in zip(sizes[:-1], sizes[1:]):
        w = torch.tensor((rng.normal(size=(o, i)) * np.sqrt(2.0 / i)).astype(np.float32),
                         device=DEVICE)
        b = torch.tensor((rng.normal(size=o) * 0.1).astype(np.float32), device=DEVICE)
        weights.append((w.T, b))
    x = torch.tensor(rng.normal(size=(rows, sizes[0])).astype(np.float32), device=DEVICE)
    return x, weights, ["leaky_relu"] * (len(sizes) - 2) + ["linear"]


def k3_shapes_phase(torch, name, shapes, timed, launch_floor_ms, sleep_cycles=2_000_000_000):
    """K3 at ``shapes`` (label -> rows, sizes, activations, the route
    expected, seed) against its plain version and one torch.addmm per layer
    (rtol 1e-5, atol 1e-5, as phase 8), each route checked; at the labels in
    ``timed``, CUDA-event times of the kernel, the plain version and the
    addmm (a yardstick the port never calls) beside the bound from this
    run's inputs."""
    from reagent_tpu_torch.ops import fused_mlp

    out = {}
    for label, (rows, sizes, acts, want_resident, seed) in shapes.items():
        x, weights, _ = k3_eval_inputs(torch, rows, sizes, seed)
        resident = fused_mlp.takes_resident_route(rows, weights)
        if resident != want_resident:
            raise AssertionError(f"K3 {label}: resident route {resident}")
        row = k3_row(torch, name, label, x, weights, acts, launch_floor_ms,
                     timed=label in timed, sleep_cycles=sleep_cycles)
        if row is not None:
            out[label] = row
    return out


# Every K3 row's call, as (spec, row dict or None), for k3_kernels_phase.
K3_CALLS = []


def k3_call_spec(label, x, weights, acts, route):
    """What fixes the CUDA kernels of a K3 call: rows, widths, each weight's
    strides (the layout picks the kernel), activations and the route."""
    return dict(label=label, rows=x.shape[0], sizes=[x.shape[1]] + [w.shape[1] for w, _ in weights],
                strides=[list(w.stride()) for w, _ in weights], acts=list(acts), route=route)


def k3_kernels_child(path):
    """``chip_smoke.py --k3-kernels-a-call SPECS.json``: in this fresh
    process, the CUDA kernels one K3 call runs at each spec's shape and
    layout (torch.profiler over one call after a warm-up), written to
    SPECS.json.out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from reagent_tpu_torch.ops import fused_mlp

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    counts = []
    with open(path) as f:
        specs = json.load(f)
    for spec in specs:
        x = torch.randn((spec["rows"], spec["sizes"][0]), device=DEVICE, generator=gen)
        weights = []
        for (i, o), stride in zip(zip(spec["sizes"][:-1], spec["sizes"][1:]), spec["strides"]):
            w = torch.empty_strided((i, o), stride, device=DEVICE)
            w.copy_(torch.randn((i, o), device=DEVICE, generator=gen) / i ** 0.5)
            weights.append((w, torch.zeros(o, device=DEVICE)))
        fused_mlp.fused_mlp_forward(x, weights, spec["acts"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fused_mlp.fused_mlp_forward(x, weights, spec["acts"])
            torch.cuda.synchronize()
        counts.append(round(sum(c for _, c, key in profiled_rows(prof, 1)[0] if "mlp" in key)))
    with open(path + ".out", "w") as f:
        json.dump(counts, f)
    return 0


def k3_kernels_phase():
    """The CUDA kernels a call of every K3 row so far, counted with
    torch.profiler in a fresh process: 1 on the resident route, one a layer
    on the streamed route (AssertionError otherwise); each timed row gets
    its count.  Late in this script a profiled window around one small call
    came back with none or only some of its kernels (phase 21, on either
    activity set, with the host idle 1 s inside the window), while a fresh
    process counts every one."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "k3_specs.json")
        with open(path, "w") as f:
            json.dump([spec for spec, _ in K3_CALLS], f)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--k3-kernels-a-call",
                               path], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"the K3 kernel count failed:\n{proc.stdout}\n{proc.stderr}")
        with open(path + ".out") as f:
            counts = json.load(f)
    for (spec, row), n in zip(K3_CALLS, counts):
        want = 1 if spec["route"] == "resident" else len(spec["acts"])
        log(f"  K3 {spec['label']} ({spec['route']} route): {n} CUDA kernels a call")
        if n != want:
            raise AssertionError(f"K3 {spec['label']}: {n} CUDA kernels a call on the "
                                 f"{spec['route']} route, not {want}")
        if row is not None:
            row["cuda_kernels_a_call"] = n
    return len(counts)


def k3_row(torch, name, label, x, weights, acts, launch_floor_ms, timed=True,
           sleep_cycles=2_000_000_000):
    """K3 on ``(x, weights, acts)`` against its plain version and one
    torch.addmm per layer (rtol 1e-5, atol 1e-5); where ``timed``, the
    CUDA-event times of the kernel, the plain version and the addmm (a
    yardstick the port never calls) beside the bound from these inputs, as
    a row of the kernels line (else None)."""
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.ops.fused_dqn import _act

    rows = x.shape[0]
    sizes = [x.shape[1]] + [w.shape[1] for w, _ in weights]
    route = "resident" if fused_mlp.takes_resident_route(rows, weights) else "streamed"
    y = fused_mlp.fused_mlp_forward(x, weights, acts)
    yp = fused_mlp.fused_mlp_forward_reference(x, weights, acts)
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
    err = (y - yp).abs().max().item()

    def addmm():
        h = x
        for (w, b), a in zip(weights, acts):
            h = _act(a, torch.addmm(b, h, w))
        return h

    torch.testing.assert_close(addmm(), y, rtol=1e-5, atol=1e-5)
    spec = k3_call_spec(label, x, weights, acts, route)
    if not timed:
        K3_CALLS.append((spec, None))
        log(f"  K3 {label}: max abs {err:.3e} against the plain version ({route} route)")
        return None
    macs = sum(i * o for i, o in zip(sizes[:-1], sizes[1:]))
    flops = 2.0 * rows * macs
    nbytes = 4.0 * (rows * sizes[0] + macs + sum(sizes[1:]) + rows * sizes[-1])
    b_ms, b_by = roofline(flops, nbytes, name)
    plain_w = [(w.contiguous(), b) for w, b in weights]  # timed without its copies
    t = dict(
        ms=time_ms(torch, lambda: fused_mlp.fused_mlp_forward(x, weights, acts),
                   sleep_cycles=sleep_cycles),
        plain_ms=time_ms(torch, lambda: fused_mlp.fused_mlp_forward_reference(
            x, plain_w, acts), sleep_cycles=sleep_cycles),
        products_library_ms=time_ms(torch, addmm, sleep_cycles=sleep_cycles),
        bound_ms=b_ms, bound_by=b_by,
        max_abs_err=err, route=route)
    K3_CALLS.append((spec, t))
    log(f"  K3 {label} ({route} route): kernel {t['ms']:.4f} ms (launch floor "
        f"{launch_floor_ms:.4f}), plain {t['plain_ms']:.4f} ms, one torch.addmm per layer "
        f"(a yardstick only) {t['products_library_ms']:.4f} ms, bound {b_ms:.6f} ms "
        f"({b_by}; {flops:.4g} FLOP, {nbytes:.4g} B), max abs {err:.3e}, on {card_line()}")
    return t


def eval_split(df, split):
    from reagent_tpu_torch.data.data_module import (
        TableSpec,
        get_sample_range,
        split_by_sample_range,
    )

    ranges = get_sample_range(TableSpec(**table_split(split)), True)
    return split_by_sample_range(df, ranges.eval_sample_range)


def evaluation_parts(torch, trainer, tstate, batch_pre, eval_df, bs, names):
    """Where ``eval_seconds`` goes, by the host clock, in a run of the
    workflow's evaluation taken apart: decoding the eval split's batches, the
    page's three forwards (K3) with their copies to the host, assembling the
    page, DM/IPS/DR, the padding, seq-DR, WDR and MAGIC (each ends in host
    values, so each time holds its device work)."""
    from reagent_tpu_torch.data.data_module import iterate_minibatches
    from reagent_tpu_torch.evaluation import EvaluationDataPage, Evaluator
    from reagent_tpu_torch.evaluation.torch_sequential_estimators import pad_edp_trajectories

    t = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        t[key] = time.perf_counter() - t0
        return out

    batches = timed("host decode", lambda: [batch_pre(b) for b in iterate_minibatches(
        eval_df, min(bs, len(eval_df)), drop_last=False)])
    pages = timed("three forwards (K3)", lambda: [
        EvaluationDataPage.create_from_tensors_dqn(
            trainer, tstate, b.extras.mdp_id, b.extras.sequence_number,
            b.state.float_features, b.action,
            torch.clamp(b.extras.action_probability, min=1e-6), b.reward,
            b.possible_actions_mask) for b in batches])

    def assemble():
        edp = pages[0]
        for p in pages[1:]:
            edp = edp.append(p)
        edp = edp.sort().compute_values(trainer.gamma)
        edp.validate()
        return edp

    edp = timed("page assembly", assemble)
    ev = Evaluator(names, trainer.gamma, device=trainer.device)
    np.random.seed(0)
    timed("DM, IPS, DR", lambda: ev.doubly_robust_estimator.estimate(edp))
    padded = timed("padding", lambda: pad_edp_trajectories(edp, trainer.device))
    timed("seq-DR", lambda: ev.sequential_doubly_robust_estimator.estimate_padded(padded))
    wdr = ev.weighted_sequential_doubly_robust_estimator
    timed("WDR", lambda: wdr.estimate_padded(padded, 1, True))
    timed("MAGIC", lambda: wdr.estimate_padded(padded, ev.NUM_J_STEPS_FOR_MAGIC_ESTIMATOR, True))
    return t, tuple(padded.rewards.shape)


def log_estimates(label, details):
    for name in details.reward_estimates._fields:
        e = getattr(details.reward_estimates, name)
        log(f"    {label} {name}: raw {e.raw:.6g} +/- {e.raw_std_error:.4g}, normalized "
            f"{e.normalized:.6g} +/- {e.normalized_std_error:.4g}")
    log(f"    {label} q-value means {details.q_value_means}, stds {details.q_value_stds}, "
        f"action distribution {details.action_distribution}")


def check_details(label, details, names):
    """Every estimate finite and on the normalised branch (rewards in
    (0, 1)), the q-value statistics finite, the action distribution a
    distribution over ``names``."""
    for name in details.reward_estimates._fields:
        e = getattr(details.reward_estimates, name)
        if e is None or not np.isfinite(list(e)).all() or e.normalized == 0.0:
            raise AssertionError(f"{label}: estimate {name} is {e}")
    for stat in (details.q_value_means, details.q_value_stds):
        if list(stat) != names or not np.isfinite(list(stat.values())).all():
            raise AssertionError(f"{label}: q-value statistics {stat}")
    dist = details.action_distribution
    if list(dist) != names or abs(sum(dist.values()) - 1.0) > 1e-9:
        raise AssertionError(f"{label}: action distribution {dist}")


def cpe_workflow_phase(torch, tmp, label, cfg, model, n_rows, epochs, split):
    """identify_and_train_network with CPE on: the unfused DQNTrainer with
    its three heads, then the eval split's page through K3 (three launches
    a batch, no plain version) and the estimators on the card; the
    artifact against the in-process module; eval_seconds taken apart."""
    reset_counts()
    out, df, serving, (trainer, tstate, _), batch_pre, wall = run_workflow(
        cfg, n_rows, epochs, torch, tmp, label, model=model, split=split, rewards="uniform")
    launches, plain_calls = read_counts()
    steps, secs = out.logger_data["train_steps"], out.logger_data["train_seconds"]
    eval_s, td = out.logger_data["eval_seconds"], out.training_report.td_loss
    names = model["DiscreteDQN"]["trainer_param"]["actions"]
    bs = model["DiscreteDQN"]["trainer_param"]["minibatch_size"]
    eval_df = eval_split(df, split)
    n_batches = -(-len(eval_df) // min(bs, len(eval_df)))
    log(f"  {label}: {steps} train steps in {secs:.3f} s ({steps / secs:.2f} steps/s, host "
        f"time included), td_loss {td}; evaluation of {len(eval_df)} rows in {n_batches} "
        f"batch(es): eval_seconds {eval_s:.3f}; whole workflow {wall:.1f} s; launches "
        f"{launches}, plain-version calls {plain_calls}")
    expected = {k: 0 for k in launches}
    expected["fused_mlp_forward"] = 3 * n_batches
    if launches != expected or plain_calls:
        raise AssertionError(f"{label}: launches {launches} (expected {expected}), plain "
                             f"calls {plain_calls}")
    if td is None or not np.isfinite(td) or steps == 0:
        raise AssertionError(f"{label}: td_loss {td} after {steps} steps")
    details = out.training_report.cpe_details
    check_details(label, details, names)
    log_estimates(label, details)
    diff = check_artifact(out, df, serving, torch)
    parts, padded = evaluation_parts(torch, trainer, tstate, batch_pre, eval_df, bs, names)
    log(f"  {label}: artifact vs in-process serving module on 64 rows: max abs {diff:.3e}; "
        f"the evaluation taken apart ({padded[0]} episodes padded to {padded[1]} steps), "
        f"seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.4f}")
    return dict(launches=launches["fused_mlp_forward"], steps=steps, secs=secs,
                eval_seconds=eval_s, parts=parts, trainer=trainer, tstate=tstate,
                batch_pre=batch_pre, eval_df=eval_df, bs=bs, names=names, details=details)


def cpu_twin(trainer):
    """The same DQNTrainer on the CPU: copies of its networks, its RL
    parameters (no optimizer: the twin only scores)."""
    import copy

    from reagent_tpu_torch.training.dqn_trainer import DQNTrainer

    return DQNTrainer(
        copy.deepcopy(trainer.q_network).cpu(), rl=trainer.rl,
        double_q_learning=trainer.double_q_learning,
        reward_network=copy.deepcopy(trainer.reward_network).cpu(),
        q_network_cpe=copy.deepcopy(trainer.q_network_cpe).cpu(), device="cpu")


# the page and estimates, card against CPU: float32 forwards in another
# order (K3's sums against the CPU's), the estimates' float32 device sums
# against the CPU's; MAGIC twice as loose as WDR (its SLSQP).  The target
# policy's propensities are softmax(Q / T) at the configs' temperature
# (RLParameters' 0.01): a propensity moves by up to 2 |dQ| / T of itself,
# 2e-3 for the 1e-5 by which the two sides' Q-values may part
EDP_TOL = dict(rtol=1e-4, atol=1e-5)
PROPENSITY_TOL = dict(rtol=2e-3, atol=1e-6)
EST_TOL = dict(rtol=1e-4, atol=1e-6)
MAGIC_EST_TOL = dict(rtol=2e-4, atol=2e-6)
STD_EST_TOL = dict(rtol=1e-3, atol=1e-6)


def cpe_edp_against_cpu(torch, run, label):
    """The evaluation page and every estimate from one trained state on the
    card and on the CPU (its twin), ``np.random`` seeded alike; argmax
    flips counted where the top two Q-values are within 1e-4."""
    from reagent_tpu_torch.evaluation import Evaluator
    from reagent_tpu_torch.workflow.training import _build_edp

    trainer, bs = run["trainer"], run["bs"]
    twin, state_c = cpu_twin(trainer), copy_state(run["tstate"], "cpu")
    batch_pre = run["batch_pre"]
    reset_counts()
    edp_g = _build_edp(trainer, run["tstate"], batch_pre, run["eval_df"], bs)
    edp_c = _build_edp(twin, state_c, lambda d: batch_pre(d).to("cpu"), run["eval_df"], bs)
    worst = 0.0
    for name in ("optimal_q_values", "model_values", "model_rewards",
                 "model_rewards_for_logged_action", "logged_values"):
        a, b = getattr(edp_g, name), getattr(edp_c, name)
        np.testing.assert_allclose(a, b, **EDP_TOL, err_msg=f"{label} page {name}")
        worst = max(worst, float(np.abs(a - b).max()))
    a, b = edp_g.model_propensities, edp_c.model_propensities
    np.testing.assert_allclose(a, b, **PROPENSITY_TOL, err_msg=f"{label} page propensities")
    above = b >= PROPENSITY_TOL["atol"]
    worst_p = float((np.abs(a - b)[above] / b[above]).max())
    top2 = np.sort(edp_c.optimal_q_values, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    flips = int((edp_g.eval_action_idxs != edp_c.eval_action_idxs).sum())
    np.testing.assert_array_equal(edp_g.eval_action_idxs[clear], edp_c.eval_action_idxs[clear])
    details = {}
    for dev, edp in ((DEVICE, edp_g), ("cpu", edp_c)):
        np.random.seed(5)
        details[dev] = Evaluator(run["names"], trainer.gamma, device=dev).evaluate_post_training(edp)
    worst_est = 0.0
    for name in details["cpu"].reward_estimates._fields:
        g = getattr(details[DEVICE].reward_estimates, name)
        c = getattr(details["cpu"].reward_estimates, name)
        tol = MAGIC_EST_TOL if name == "magic" else EST_TOL
        np.testing.assert_allclose(g[:2], c[:2], **tol, err_msg=f"{label} {name}")
        np.testing.assert_allclose(g[2:], c[2:], **STD_EST_TOL, err_msg=f"{label} {name} std")
        worst_est = max(worst_est, max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(g, c)))
    launches, plain_calls = read_counts()
    log(f"  {label}: page card vs CPU max abs {worst:.3e} (Q-values, rewards, values), "
        f"propensities above 1e-6 max rel {worst_p:.3e}, greedy-action flips {flips} of "
        f"{len(clear)} ({int((~clear).sum())} rows within 1e-4 of a tie); estimates max rel "
        f"{worst_est:.3e}; K3 launches on the card {launches['fused_mlp_forward']}, "
        f"plain-version calls (the CPU side) {plain_calls}")
    return worst, worst_est


def cpe_lockstep_phase(torch, n=5):
    """``n`` DQNTrainer steps with the CPE heads at the full offline width on
    the card and on the CPU from one initial state and the same batches:
    td_loss, reward_loss and cpe_td_loss per step to rtol 1e-4, atol 1e-5
    (as phase 15), the five parameter trees to rtol 1e-3, atol 1e-4.
    Returns the card's trainer and its trained state."""
    import copy

    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.net_builder.discrete_dqn import FullyConnected
    from reagent_tpu_torch.training.dqn_trainer import DQNTrainer

    cfg = FULL
    build = FullyConnected(sizes=cfg["widths"], activations=[cfg["act"]] * len(cfg["widths"]))
    nets = [build.build_q_network(None, cfg["A"], state_dim=cfg["D"]) for _ in range(3)]
    kw = dict(rl=RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"]),
              optimizer={"Adam": {"lr": cfg["lr"]}})
    trainers = {
        "cpu": DQNTrainer(copy.deepcopy(nets[0]), reward_network=copy.deepcopy(nets[1]),
                          q_network_cpe=copy.deepcopy(nets[2]), device="cpu", **kw),
        DEVICE: DQNTrainer(nets[0], reward_network=nets[1], q_network_cpe=nets[2],
                           device=DEVICE, **kw)}
    first = trainers[DEVICE].init(torch.Generator().manual_seed(13))
    states = {dev: copy_state(first, dev) for dev in trainers}
    rng = np.random.default_rng(17)
    worst = {k: 0.0 for k in ("td_loss", "reward_loss", "cpe_td_loss")}
    for step in range(n):
        _, b, _ = make_inputs(cfg, 700 + step, torch, "cpu")
        obs, nobs, action, _, not_terminal, mask = b
        reward = torch.tensor(rng.uniform(0, 1, (cfg["B"], 1)).astype(np.float32))
        metrics = {}
        for dev, trainer in trainers.items():
            batch = rlt.DiscreteDqnInput(
                state=rlt.FeatureData(obs), next_state=rlt.FeatureData(nobs), action=action,
                next_action=action, reward=reward, time_diff=None, step=None,
                not_terminal=not_terminal, possible_actions_mask=torch.ones_like(mask),
                possible_next_actions_mask=mask).to(dev)
            states[dev], m = trainer.train_step(states[dev], batch)
            metrics[dev] = {k: m[k].cpu() for k in worst}
        for k in worst:
            torch.testing.assert_close(metrics[DEVICE][k], metrics["cpu"][k],
                                       rtol=1e-4, atol=1e-5)
            worst[k] = max(worst[k], (metrics[DEVICE][k] - metrics["cpu"][k]).abs().item())
    worst_p = 0.0
    g, c = states[DEVICE], states["cpu"]
    for tree in ("q_params", "q_target_params", "reward_params", "cpe_params",
                 "cpe_target_params"):
        for k, v in getattr(c, tree).items():
            a = getattr(g, tree)[k].cpu()
            torch.testing.assert_close(a, v, rtol=1e-3, atol=1e-4)
            worst_p = max(worst_p, (a - v).abs().max().item())
    log(f"  card vs CPU, {n} lockstep train steps with the CPE heads: max abs "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (last {', '.join(f'{k} {metrics[DEVICE][k].item():.6f}' for k in worst)}); "
        f"the five parameter trees max abs {worst_p:.3e}")
    return trainers[DEVICE], states[DEVICE]

# ------------------------------------------------- batch-RL slice: the e2e job

# The reference's dqn_cartpole_e2e job (tests/test_offline_e2e.py:75-140): the
# flagship sample config with the CI job's overrides; its four reagent run
# commands, called here as functions (tests/test_torch_cli.py holds their
# arguments to the ones reagent run builds from the YAML)
E2E_JOB = dict(env_name="CartPole-v1", num_train_transitions=12000, max_steps=200,
               num_eval_episodes=20, passing_score_bar=120.0)
HOST_PACKAGES = ("gymnasium", "click", "yaml", "tensorboard")


def e2e_overrides(tmp):
    """The job's --extra-options, its files under ``tmp``."""
    return {
        **E2E_JOB,
        "pkl_path": os.path.join(tmp, "pre_timeline.pkl"),
        "input_table_spec": {
            "table_name": "cartpole_offline", "path": os.path.join(tmp, "table.pkl"),
            "table_sample": SAMPLE_CONFIG["table_sample"],
            "eval_table_sample": SAMPLE_CONFIG["eval_table_sample"]},
        "output_dir": os.path.join(tmp, "model"),
        "model_path": os.path.join(tmp, "model", "serving_model"),
        "device": DEVICE,
    }


def e2e_config(tmp):
    """The sample config as reagent run reads it, updated with the overrides."""
    return {"model": SAMPLE_CONFIG["model"], "num_epochs": SAMPLE_CONFIG["num_epochs"],
            **e2e_overrides(tmp)}


def e2e_funcs():
    from reagent_tpu_torch.workflow import gym_batch_rl, training

    return (gym_batch_rl.offline_gym_random, gym_batch_rl.timeline_operator,
            training.identify_and_train_network, gym_batch_rl.evaluate_gym)


def e2e_kwargs(tmp):
    """Each command's keyword arguments, as reagent run builds them."""
    from reagent_tpu_torch.core.configuration import kwargs_from_config

    config = e2e_config(tmp)
    return [kwargs_from_config(f, config) for f in e2e_funcs()]


class HostEnv:
    """One of the port's functional envs on the host behind the ``Gym``
    adapter's interface: a job's env where gymnasium is not installed.  A
    reset draws the state's uniforms from a numpy generator, reseeded by a
    seeded reset."""

    def __init__(self, env):
        self.env = env
        self.rng = np.random.default_rng(0)

    def reset(self, seed=None):
        import torch

        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state, obs = self.env.reset_from_uniform(
            torch.tensor(self.rng.random(self.env.reset_noise_dim), dtype=torch.float32))
        return obs.numpy()

    def step(self, action):
        import torch

        self.state, obs, reward, done = self.env.step(
            self.state, torch.as_tensor(np.asarray(action)))
        return obs.numpy(), float(reward), bool(done)

    def close(self):
        pass


class HostCartPole(HostEnv):
    class action_space:
        n = 2

    def __init__(self, max_steps):
        from reagent_tpu_torch.gym.envs import CartPole

        super().__init__(CartPole(max_steps=max_steps, device="cpu"))


class HostPendulum(HostEnv):
    """Pendulum-v1's box of torques, as ``random_rollouts`` reads it."""

    class action_space:
        low = np.array([-2.0], np.float32)
        high = np.array([2.0], np.float32)

    def __init__(self, max_steps):
        from reagent_tpu_torch.gym.envs import Pendulum

        super().__init__(Pendulum(max_steps=max_steps, device="cpu"))


class RecordingWriter:
    """A summary writer that keeps what it is given (no tensorboard needed)."""

    def __init__(self):
        self.scalars, self.histograms = {}, {}

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.setdefault(tag, []).append((global_step, float(value)))

    def add_histogram(self, tag, values, global_step=None):
        self.histograms.setdefault(tag, []).append((global_step, np.asarray(values).shape))


def reporter_copies(torch, trainer, tstate, batches, reporter):
    """Device-to-host copies per train step, without and with the reporter's
    log (torch.profiler, the CUDA copies), and the reporter's host ms per
    log of a finished step's metrics (no wait on the queue)."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for with_reporter in (False, True):
        state = tstate
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for batch in batches:
                state, metrics = trainer.train_step(state, batch)
                if with_reporter:
                    reporter.log(**metrics)
            torch.cuda.synchronize()
        rows, _ = profiled_rows(prof, len(batches))
        counts[with_reporter] = sum(count for _, count, key in rows if "DtoH" in key)
    host_ms = []
    state = tstate
    for batch in batches:
        state, metrics = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reporter.log(**metrics)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    return counts[False], counts[True], statistics.median(host_ms)


def e2e_phase(torch, tmp):
    """The dqn_cartpole_e2e job on the card: random CartPole rows, the
    timeline operator, the flagship sample config (unfused DQNTrainer with
    its CPE heads, the DiscreteDQNReporter writing to a recording summary
    writer), the artifact, and 20 greedy episodes against the 120 bar.
    gymnasium's CartPole-v1 where it imports, else the port's functional
    CartPole on the host (the same columns, seeded numpy actions)."""
    import inspect

    import pandas as pd

    from reagent_tpu_torch.core.tracker import summary_writer_context
    from reagent_tpu_torch.data.data_module import iterate_minibatches
    from reagent_tpu_torch.prediction.predictor_wrapper import load_predictor
    from reagent_tpu_torch.workflow import gym_batch_rl

    have = {m: importlib.util.find_spec(m) is not None for m in HOST_PACKAGES}
    log(f"  host packages importable on this machine: {have}")
    collect, timeline, train, evaluate = e2e_kwargs(tmp)
    t0 = time.perf_counter()
    if have["gymnasium"]:
        route = "gymnasium CartPole-v1"
        gym_batch_rl.offline_gym_random(**collect)
    else:
        route = "the port's functional CartPole on the host"
        seed = collect.get("seed", inspect.signature(
            gym_batch_rl.offline_gym_random).parameters["seed"].default)
        gym_batch_rl.random_rollouts(
            HostCartPole(collect["max_steps"]), collect["num_train_transitions"], seed,
        ).to_pickle(collect["pkl_path"])
    collect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gym_batch_rl.timeline_operator(**timeline)
    timeline_s = time.perf_counter() - t0
    spec = timeline["input_table_spec"]
    df = pd.read_pickle(spec.path)
    log(f"  env: {route}; {collect['num_train_transitions']} random transitions in "
        f"{collect_s:.2f} s, {df.mdp_id.nunique()} episodes; timeline: {len(df)} rows in "
        f"{timeline_s:.2f} s")

    writer = RecordingWriter()
    reset_counts()
    with capturing_manager(train["model"]) as captured, summary_writer_context(writer):
        out = e2e_funcs()[2](**train)
    launches, plain_calls = read_counts()
    data = out.logger_data
    steps, secs = data["train_steps"], data["train_seconds"]
    bs = train["model"]["DiscreteDQN"]["trainer_param"]["minibatch_size"]
    eval_df = eval_split(df, (spec.table_sample, spec.eval_table_sample))
    n_batches = -(-len(eval_df) // min(bs, len(eval_df)))
    log(f"  {steps} train steps in {secs:.3f} s ({steps / secs:.2f} steps/s, host time and "
        f"the reporter included), the reporter's log and flush {data['report_seconds']:.3f} s "
        f"({data['report_seconds'] / steps * 1e3:.3f} ms a step, each log waiting for its "
        f"step), td_loss {out.training_report.td_loss}; evaluation of {len(eval_df)} rows in "
        f"{n_batches} batch(es): eval_seconds {data['eval_seconds']:.3f}; launches "
        f"{launches}, plain-version calls {plain_calls}")
    expected = {k: 0 for k in launches}
    expected["fused_mlp_forward"] = 3 * n_batches
    if launches != expected or plain_calls or n_batches == 0:
        raise AssertionError(f"e2e: launches {launches} (expected {expected}), plain calls "
                             f"{plain_calls}")
    tags = (sorted(writer.scalars), sorted(writer.histograms))
    log(f"  summary writer: {len(tags[0])} scalar tags, {len(tags[1])} histogram tags: "
        f"scalars {tags[0]}; histograms {tags[1]}")
    if not ({"actions/logged/0", "actions/logged/1"} <= set(writer.scalars)
            and "td_loss" in writer.histograms):
        raise AssertionError("e2e: the reporter's action counts or td_loss histogram are "
                             "missing")
    details = out.training_report.cpe_details
    dm = details.reward_estimates.direct_method.raw
    if not np.isfinite(dm):
        raise AssertionError(f"e2e: direct method estimate {dm}")
    log_estimates("e2e", details)
    diff = check_artifact(out, df, captured["build_serving_module"], torch)
    trainer, tstate, _ = captured["build_serving_module_args"]
    batches = [captured["build_batch_preprocessor"](b)
               for b, _ in zip(iterate_minibatches(df, bs, seed=0), range(5))]
    bare, reported, log_ms = reporter_copies(torch, trainer, tstate, batches,
                                             captured["get_reporter"])
    log(f"  artifact vs in-process serving module on 64 rows: max abs {diff:.3e}; "
        f"device-to-host copies a train step (torch.profiler, 5 steps): {bare:.1f} without "
        f"the reporter, {reported:.1f} with it; the reporter's log of a finished step "
        f"{log_ms:.3f} ms on the host (median of 5), on {card_line()}")
    if reported - bare != 1:
        raise AssertionError(f"e2e: the reporter made {reported - bare} copies a step")

    bar = evaluate["passing_score_bar"]
    t0 = time.perf_counter()
    if have["gymnasium"]:
        mean = gym_batch_rl.evaluate_gym(**evaluate)
    else:
        returns = gym_batch_rl.greedy_returns(
            load_predictor(evaluate["model_path"]), HostCartPole(evaluate["max_steps"]),
            evaluate["num_eval_episodes"])
        mean = float(np.mean(returns))
        if not mean >= bar:
            raise AssertionError(f"{mean} <= {bar}, eval failed")
    log(f"  {evaluate['num_eval_episodes']} greedy episodes of at most "
        f"{evaluate['max_steps']} steps ({route}) through load_predictor: mean reward "
        f"{mean:.2f} against the bar {bar} in {time.perf_counter() - t0:.2f} s")
    return dict(launches=launches["fused_mlp_forward"], steps=steps, secs=secs,
                report_seconds=data["report_seconds"], eval_seconds=data["eval_seconds"],
                copies=(bare, reported), log_ms=log_ms, mean_reward=mean, route=route)


# -------------------------------- batch-RL slice: warm start at full width

# two minibatches of 4,096 an epoch, 4 epochs: 8 K1 updates a run
WARM_ROWS, WARM_EPOCHS = 8192, 4
WARM_METRIC_REWARDS = {"ctr": 1.0, "watch": 0.5}


def warm_start_phase(torch, tmp, cpe_trainer, cpe_state):
    """identify_and_train_network twice at the full offline width through
    K1 (fused, block_size set) with a warm-start checkpoint and
    metric-weighted rewards: the saved step doubles, the checkpoint restores
    each run's final state bit for bit on the card, and K1 launches once a
    step.  Then an unfused DQNTrainerState with its five CPE fields (phase
    24's) saved and restored on the card."""
    from reagent_tpu_torch.data.data_module import TableSpec
    from reagent_tpu_torch.utils.checkpointing import (
        flatten_state,
        restore_checkpoint,
        save_checkpoint,
    )
    from reagent_tpu_torch.workflow.training import identify_and_train_network

    def assert_restores(path, template, state, label):
        got, want = flatten_state(restore_checkpoint(path, template)), flatten_state(state)
        for key, w in want.items():
            if not (got[key].device == w.device and torch.equal(got[key], w)):
                raise AssertionError(f"{label}: {key} restored as {got[key].device} "
                                     f"{got[key].dtype}, not bit for bit")
        return len(want)

    cfg = FULL
    table = os.path.join(tmp, "warm_start.pkl")
    make_table(table, WARM_ROWS, cfg["D"], cfg["A"], seed=7, metrics=True)
    model = fused_model(cfg)
    warm = os.path.join(tmp, "warm_start.ckpt")
    reset_counts()
    saved, total_steps = [], 0
    for run in (1, 2):
        with capturing_manager(model) as captured:
            out = identify_and_train_network(
                TableSpec(table_name="warm_start", path=table), model, num_epochs=WARM_EPOCHS,
                output_dir=os.path.join(tmp, f"warm_start_{run}"), warm_start_path=warm,
                reward_options={"metric_reward_values": WARM_METRIC_REWARDS}, device=DEVICE)
        trainer, tstate, _ = captured["build_serving_module_args"]
        n = assert_restores(warm, trainer.init(torch.Generator().manual_seed(run)), tstate,
                            f"warm start run {run}")
        saved.append(int(tstate.step))
        steps, secs = out.logger_data["train_steps"], out.logger_data["train_seconds"]
        total_steps += steps
        log(f"  run {run}: {steps} train steps in {secs:.3f} s ({steps / secs:.2f} steps/s, "
            f"host time included), td_loss {out.training_report.td_loss}, saved step "
            f"{saved[-1]}; the checkpoint restores its {n} tensors bit for bit on "
            f"{tstate.step.device}")
    launches, plain_calls = read_counts()
    expected = {k: 0 for k in launches}
    expected["fused_dqn_offline_update"] = total_steps
    log(f"  launches {launches}, plain-version calls {plain_calls}")
    if saved[1] != 2 * saved[0] or saved[0] != total_steps // 2 or total_steps != 16:
        raise AssertionError(f"warm start: saved steps {saved} after {total_steps} updates")
    if launches != expected or plain_calls:
        raise AssertionError(f"warm start: launches {launches} (expected {expected}), plain "
                             f"calls {plain_calls}")
    path = os.path.join(tmp, "cpe_state.ckpt")
    save_checkpoint(path, cpe_state)
    n = assert_restores(path, cpe_trainer.init(torch.Generator().manual_seed(1)), cpe_state,
                        "DQNTrainerState with CPE heads")
    log(f"  DQNTrainerState with its five CPE fields (phase 24's, step "
        f"{int(cpe_state.step)}): {n} tensors restored bit for bit on {cpe_state.step.device}")
    return dict(launches=launches["fused_dqn_offline_update"], saved=saved)


# ------------------------------------------- actor-critic slice: SAC and TD3

SAC_YAML = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reagent_tpu_torch",
                        "workflow", "sample_configs", "sac_pendulum_offline.yaml")
# the job's depth cuts on the card (PERF.md §4): the rest of the sample
# config (widths, minibatch, optimizers, gamma, tau, seed, the bar) unchanged
SAC_JOB_CUT = dict(num_epochs=10, num_train_transitions=20000, num_eval_episodes=5,
                   max_steps=1000)
AC_STEP_TOL = dict(rtol=1e-4, atol=1e-5)
AC_PARAM_TOL = dict(rtol=1e-3, atol=1e-4)


def sac_sample_config():
    """The sample config as ``reagent run`` reads it."""
    import yaml

    with open(SAC_YAML) as f:
        return yaml.safe_load(f)


def sac_job_overrides(tmp, cut=True):
    """The job's --extra-options: its files under ``tmp``, the depth cuts
    (none where ``cut`` is False: the sample config unchanged), the card."""
    spec = dict(sac_sample_config()["input_table_spec"])
    spec["path"] = os.path.join(tmp, "table.pkl")
    return {
        **(SAC_JOB_CUT if cut else {}),
        "pkl_path": os.path.join(tmp, "pre_timeline.pkl"),
        "input_table_spec": spec,
        "output_dir": os.path.join(tmp, "model"),
        "model_path": os.path.join(tmp, "model", "serving_model"),
        "device": DEVICE,
    }


def reagent_run(entry, overrides):
    """``reagent run <entry> sac_pendulum_offline.yaml --extra-options ...``
    in this process (the port's CLI, click's own parsing)."""
    from reagent_tpu_torch.workflow.cli import reagent

    reagent.main(["run", entry, SAC_YAML, "--extra-options", json.dumps(overrides)],
                 standalone_mode=False)


@contextlib.contextmanager
def recording(module, name):
    """Keep each return of ``module.name`` called in the block."""
    from unittest import mock

    original, results = getattr(module, name), []

    def wrapper(*args, **kwargs):
        results.append(original(*args, **kwargs))
        return results[-1]

    with mock.patch.object(module, name, wrapper):
        yield results


def ac_lockstep_trainers(torch, name):
    """The sample config's manager (SAC) or its TD3 twin built twice, on the
    CPU and on the card, for 3 state features and 1 action; the CPU
    trainer's init (seed 12) copied to the card."""
    import copy

    import reagent_tpu_torch.model_managers  # noqa: F401 — registers the managers
    from reagent_tpu_torch.core.parameters import NormalizationData, NormalizationParameters
    from reagent_tpu_torch.core.registry import MODEL_MANAGERS

    model = copy.deepcopy(sac_sample_config()["model"])
    if name == "TD3":
        sac = model.pop("SAC")
        trainer_param = {k: v for k, v in sac["trainer_param"].items()
                         if k != "entropy_temperature"}
        model["TD3"] = dict(trainer_param=trainer_param,
                            actor_net_builder={"FullyConnected": next(iter(
                                sac["actor_net_builder"].values()))},
                            critic_net_builder=sac["critic_net_builder"])
    manager = MODEL_MANAGERS.build(model)
    ndm = {"state": NormalizationData({i: NormalizationParameters(
               "CONTINUOUS", mean=0.0, stddev=1.0) for i in range(3)}),
           "action": NormalizationData({0: NormalizationParameters("DO_NOT_PREPROCESS")})}
    trainers = {dev: manager.build_trainer(ndm, device=dev) for dev in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(12))
    return model, manager, trainers, {dev: copy_state(first, dev) for dev in trainers}


def compare_states(torch, card_state, cpu_state, tol, label):
    """Every state tensor of the card's run against the CPU's: floats within
    ``tol``, integer leaves exactly; returns (count, max abs)."""
    from reagent_tpu_torch.utils.checkpointing import flatten_state

    card, cpu = flatten_state(card_state), flatten_state(cpu_state)
    if card.keys() != cpu.keys():
        raise AssertionError(f"{label}: the states hold other fields")
    worst = 0.0
    for key, want in cpu.items():
        got = card[key].cpu()
        if not want.is_floating_point():
            torch.testing.assert_close(got, want, rtol=0, atol=0, msg=f"{label} {key}")
            continue
        torch.testing.assert_close(got, want, **tol, msg=f"{label} {key}")
        worst = max(worst, (got - want).abs().max().item())
    return len(cpu), worst


def ac_lockstep_phase(torch, name, n):
    """``n`` train steps of the sample config's SAC trainer (twin Q,
    autotuned temperature, 64, 64 leaky_relu, minibatch 1024) or of its TD3
    twin on the card and on the CPU from one state, the same batches (3
    state features, actions in [-2, 2] as the Pendulum table logs them) and
    the same explicit noise.  Each step's metrics to rtol 1e-4, atol 1e-5;
    the final parameters, targets, Adam moments and log-alpha to rtol 1e-3,
    atol 1e-4 (float32 sums in another order, cuBLAS against the CPU, which
    Adam turns into steps of about lr wherever a gradient is near 0)."""
    from reagent_tpu_torch.core import types as rlt

    model, manager, trainers, states = ac_lockstep_trainers(torch, name)
    B = next(iter(model.values()))["trainer_param"]["minibatch_size"]
    rng = np.random.default_rng(40)
    reset_counts()
    worst_m, moved = 0.0, []
    for step in range(n):
        cols = dict(s=rng.normal(size=(B, 3)), ns=rng.normal(size=(B, 3)),
                    a=rng.uniform(-2, 2, (B, 1)), r=-rng.uniform(0, 16, (B, 1)),
                    nt=(rng.random((B, 1)) > 0.005))
        noise = rng.normal(size=(2, B, 1) if name == "SAC" else (B, 1))
        t = {k: torch.tensor(v, dtype=torch.float32) for k, v in cols.items()}
        metrics = {}
        for dev, trainer in trainers.items():
            batch = rlt.PolicyNetworkInput(
                state=rlt.FeatureData(t["s"]), next_state=rlt.FeatureData(t["ns"]),
                action=rlt.FeatureData(t["a"]), next_action=rlt.FeatureData(t["a"]),
                reward=t["r"], time_diff=None, step=None, not_terminal=t["nt"]).to(dev)
            before = states[dev].actor_params["net.layers.0.weight"]
            states[dev], m = trainer.train_step(
                states[dev], batch, torch.tensor(noise, dtype=torch.float32, device=dev))
            metrics[dev] = {k: v.cpu() for k, v in m.items()}
            if dev == DEVICE:
                moved.append(not torch.equal(before, states[dev].actor_params[
                    "net.layers.0.weight"]))
        for k, want in metrics["cpu"].items():
            torch.testing.assert_close(metrics[DEVICE][k], want, **AC_STEP_TOL, msg=k)
            worst_m = max(worst_m, (metrics[DEVICE][k] - want).abs().item())
    launches, plain_calls = read_counts()
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"{name} lockstep: launches {launches}, plain calls {plain_calls}")
    if name == "TD3" and moved != [step % 2 == 0 for step in range(n)]:
        raise AssertionError(f"TD3 lockstep: the actor moved on steps {moved}")
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], AC_PARAM_TOL, name)
    log(f"  {name}, card vs CPU, {n} lockstep train steps (minibatch {B}): metrics max abs "
        f"{worst_m:.3e} (last q1_loss {metrics[DEVICE]['q1_loss'].item():.6f}, actor_loss "
        f"{metrics[DEVICE]['actor_loss'].item():.6f}); {count} state tensors max abs "
        f"{worst_p:.3e}; the actor moved on steps {moved}; K1-K5 launches 0, plain calls 0")
    return worst_m, worst_p


def sac_job_phase(torch, tmp, cut=True):
    """The reference's sac_pendulum_e2e job on the card through the port's
    ``reagent run`` and the sample config (``cut`` False: unchanged, else
    with ``SAC_JOB_CUT``'s depths): random Pendulum rows (gymnasium where it
    imports, else the port's functional Pendulum on the host), the timeline,
    SAC with its ``ActorCriticReporter``, the actor artifact, greedy
    episodes.  Then steps/s, the host's decode against a train step, CUDA
    kernels and device-to-host copies a step, the device's idle share."""
    import inspect

    import pandas as pd

    from reagent_tpu_torch.core.configuration import kwargs_from_config
    from reagent_tpu_torch.data.data_module import iterate_minibatches
    from reagent_tpu_torch.prediction.predictor_wrapper import load_predictor
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense
    from reagent_tpu_torch.utils.checkpointing import flatten_state
    from reagent_tpu_torch.workflow import gym_batch_rl, training

    have_gym = importlib.util.find_spec("gymnasium") is not None
    overrides = sac_job_overrides(tmp, cut)
    config = {**sac_sample_config(), **overrides}
    entry = "reagent_tpu_torch.workflow.{}".format
    cuts = {k: config[k] for k in SAC_JOB_CUT}
    log(f"  depth {'cut' if cut else 'unchanged'}: {cuts}; gymnasium importable: {have_gym}")
    t0 = time.perf_counter()
    if have_gym:
        route = "gymnasium Pendulum-v1"
        reagent_run(entry("gym_batch_rl.offline_gym_random"), overrides)
    else:
        route = "the port's functional Pendulum on the host"
        collect = kwargs_from_config(gym_batch_rl.offline_gym_random, config)
        seed = collect.get("seed", inspect.signature(
            gym_batch_rl.offline_gym_random).parameters["seed"].default)
        gym_batch_rl.random_rollouts(
            HostPendulum(collect["max_steps"]), collect["num_train_transitions"], seed,
        ).to_pickle(collect["pkl_path"])
    collect_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reagent_run(entry("gym_batch_rl.timeline_operator"), overrides)
    timeline_s = time.perf_counter() - t0
    df = pd.read_pickle(overrides["input_table_spec"]["path"])
    log(f"  env: {route}; {config['num_train_transitions']} random transitions in "
        f"{collect_s:.2f} s, {df.mdp_id.nunique()} episodes; timeline: {len(df)} rows in "
        f"{timeline_s:.2f} s")

    reset_counts()
    with capturing_manager(config["model"]) as captured, \
            recording(training, "train_workflow") as results:
        reagent_run(entry("training.identify_and_train_network"), overrides)
    launches, plain_calls = read_counts()
    out = results[-1]
    data = out.logger_data
    steps, secs = data["train_steps"], data["train_seconds"]
    log(f"  {steps} train steps in {secs:.3f} s ({steps / secs:.2f} steps/s, host decode and "
        f"the reporter included; the reporter {data['report_seconds']:.3f} s), q1_loss "
        f"{out.training_report.td_loss}; K1-K5 launches {sum(launches.values())}, "
        f"plain-version calls {plain_calls} (the actor-critic path has no TPU kernel)")
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"sac job: launches {launches}, plain calls {plain_calls}")
    if not np.isfinite(out.training_report.td_loss):
        raise AssertionError(f"sac job: q1_loss {out.training_report.td_loss}")

    trainer, tstate, _ = captured["build_serving_module_args"]
    serving, batch_pre = captured["build_serving_module"], captured["build_batch_preprocessor"]
    finite = {k: bool(torch.isfinite(v).all()) for k, v in flatten_state(tstate).items()
              if v.is_floating_point()}
    if not all(finite.values()) or not np.isfinite(float(tstate.log_alpha)):
        bad = [k for k, f in finite.items() if not f]
        raise AssertionError(f"sac job: non-finite state {bad}")
    bs = config["model"]["SAC"]["trainer_param"]["minibatch_size"]
    frames = [b for b, _ in zip(iterate_minibatches(df, bs, seed=0), range(8))]
    decode_ms, dense_ms = [], []
    for frame in frames:
        t0 = time.perf_counter()
        for col, pre in (("state_features", batch_pre.state_preprocessor),
                         ("next_state_features", batch_pre.state_preprocessor),
                         ("action", batch_pre.action_preprocessor),
                         ("next_action", batch_pre.action_preprocessor)):
            sparse_to_dense(frame[col].tolist(), pre.sorted_features)
        dense_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        batch_pre(frame)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    batches = [batch_pre(frame) for frame in frames]

    def run(state=tstate):
        for batch in batches:
            state, _ = trainer.train_step(state, batch)
        return state

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) / len(batches) * 1e6
    dev_us, launches_per_step = profile_loop(torch, run, len(batches), step_us, "SAC train")
    bare, reported, log_ms = reporter_copies(torch, trainer, tstate, batches[:5],
                                             captured["get_reporter"])
    decode = statistics.median(decode_ms)
    log(f"  a train step {step_us / 1e3:.3f} ms ({len(batches)} pre-decoded batches, "
        f"synchronised at the end) beside the host's decode of its {bs}-row batch "
        f"{decode:.3f} ms (median of {len(batches)}; sparse_to_dense's four Python loops "
        f"alone {statistics.median(dense_ms):.3f} ms): decode is "
        f"{decode / (decode + step_us / 1e3) * 100:.1f}% of a decoded step; "
        f"{launches_per_step:.1f} CUDA kernels a step; device-to-host copies a step: "
        f"{bare:.1f} without the reporter, {reported:.1f} with it (log {log_ms:.3f} ms), on "
        f"{card_line()}")
    if bare != 0 or reported != 1:
        raise AssertionError(f"sac job: {bare} copies a step without the reporter, "
                             f"{reported} with it")

    path = config["model_path"]
    predictor = load_predictor(path)
    values, presence = sparse_to_dense(df["state_features"].tolist()[:64],
                                       predictor.sorted_features)
    artifact = np.concatenate([predictor.predict(
        {f: float(v) for f, v in zip(predictor.sorted_features, row)}) for row in values])
    live = serving(torch.tensor(values, device=DEVICE),
                   torch.tensor(presence, device=DEVICE)).cpu().numpy()
    diff = float(np.abs(artifact - live).max())
    log(f"  artifact: model_type {predictor.model_type!r}; 64 rows' actions in "
        f"[{artifact.min():.4f}, {artifact.max():.4f}], against the in-process serving "
        f"module max abs {diff:.3e}")
    if predictor.model_type != "actor" or artifact.shape != (64, 1):
        raise AssertionError(f"sac job: artifact {predictor.model_type} {artifact.shape}")
    if not (np.isfinite(artifact).all() and np.abs(artifact).max() <= 2.0):
        raise AssertionError(f"sac job: artifact actions {artifact.min()}, {artifact.max()}")
    np.testing.assert_allclose(artifact, live, atol=1e-4, rtol=0)

    evaluate = kwargs_from_config(gym_batch_rl.evaluate_gym, config)
    bar = evaluate.pop("passing_score_bar")
    t0 = time.perf_counter()
    if have_gym:
        mean = gym_batch_rl.evaluate_gym(**evaluate)
    else:
        mean = float(np.mean(gym_batch_rl.greedy_returns(
            predictor, HostPendulum(evaluate["max_steps"]), evaluate["num_eval_episodes"])))
    eval_seconds = time.perf_counter() - t0
    log(f"  {evaluate['num_eval_episodes']} greedy episodes of {evaluate['max_steps']} steps "
        f"({route}) through load_predictor: eval_seconds {eval_seconds:.2f}, mean reward "
        f"{mean:.2f} "
        f"(the sample config's bar {bar}: {'met' if mean >= bar else 'missed'}"
        f"{'; not held at the cut depth' if cut else ''})")
    if not np.isfinite(mean):
        raise AssertionError(f"sac job: mean reward {mean}")
    return dict(steps=steps, steps_per_s=steps / secs, step_ms=step_us / 1e3,
                decode_ms=decode, device_us=dev_us, launches_per_step=launches_per_step,
                copies=(bare, reported), eval_seconds=eval_seconds, mean_reward=mean,
                bar=bar, route=route)


# ------------------------------------------- discrete-actor slice (PR 13)

# tests/test_gym_all_algos.py:292-323 (discrete_crr_cartpole_online.yaml):
# actor and q1 128, 64 leaky_relu, gamma 0.99, tau 0.2, Adam 3e-3 both, beta
# 1; prefill 3,000 into a ReplayBuffer of 50,000, minibatch 256, 15,000
# steps, bar 100 over 20 greedy episodes of the actor; cut to ``steps`` here
CRR_ONLINE = dict(D=4, A=2, widths=[128, 64], act="leaky_relu", B=256, gamma=0.99, tau=0.2,
                  lr=3e-3, beta=1.0, prefill=3000, capacity=50_000, steps=100,
                  full_steps=15_000, bar=100.0)
# tests/test_offline_managers.py:16-57: 10,000 random CartPole transitions
# (seed 3, episodes of at most 200 steps), a 95/5 split, this model block, 20
# epochs, 20 greedy episodes of the actor artifact against 100; cut here to
# ``epochs``
CRR_OFFLINE = dict(transitions=10_000, max_steps=200, seed=3, split=(95.0, 5.0), epochs=2,
                   full_epochs=20, episodes=20, bar=100.0)
CRR_OFFLINE_MODEL = {"DiscreteCRR": {
    "trainer_param": {"actions": ["0", "1"], "rl": {"gamma": 0.99, "target_update_rate": 0.1},
                      "optimizer": {"Adam": {"lr": 0.003}}, "beta": 1.0},
    "net_builder": {"FullyConnected": {"sizes": [64, 64], "activations": ["relu", "relu"]}},
    "actor_net_builder": {"FullyConnected": {"sizes": [64, 64],
                                             "activations": ["relu", "relu"]}},
}}
# tests/test_policy_gradient_trainers.py:151-213 (discrete_reinforce/ppo_
# cartpole_online.yaml): CartPole episodes of max_steps 200, the bar 180
# over 20 greedy episodes; cut here to ``episodes``
PG_CONFIGS = {
    "REINFORCE": dict(widths=[64, 64], optimizer={"Adam": {"lr": 5e-3}},
                      kw=dict(gamma=0.99, normalize=True, subtract_mean=True),
                      episodes=4, full_episodes=300, bar=180.0),
    "PPO": dict(widths=[32, 32], optimizer={"Adam": {"lr": 1e-3, "weight_decay": 1e-3}},
                kw=dict(gamma=0.99, ppo_epsilon=0.2, update_epochs=1, normalize=True,
                        subtract_mean=True),
                episodes=4, full_episodes=700, bar=180.0),
}
PG_MAX_STEPS = 200


def crr_online_trainer(torch, device):
    """The online CRR trainer (actor and q1 only, as the reference's test)."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training.discrete_crr_trainer import DiscreteCRRTrainer

    cfg = CRR_ONLINE

    def net():
        return FullyConnectedDQN(state_dim=cfg["D"], action_dim=cfg["A"], sizes=cfg["widths"],
                                 activations=[cfg["act"]] * len(cfg["widths"]))

    return DiscreteCRRTrainer(
        actor_network=net(), q1_network=net(),
        rl=RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"]),
        q_network_optimizer={"Adam": {"lr": cfg["lr"]}},
        actor_network_optimizer={"Adam": {"lr": cfg["lr"]}}, beta=cfg["beta"], device=device)


def crr_lockstep_phase(torch, n=5):
    """``n`` CRR train steps at the online config's widths on the card and on
    the CPU from one state, on the same numpy batches (CartPole-like states,
    logged actions, rewards of 1, a few terminals): each step's metrics to
    rtol 1e-4, atol 1e-5, every state tensor to rtol 1e-3, atol 1e-4, the
    integer leaves exactly (``AC_STEP_TOL``, ``AC_PARAM_TOL``, as phase 27).
    The trainer's forwards are autograd modules: no K1-K5 launch."""
    from reagent_tpu_torch.core import types as rlt

    cfg = CRR_ONLINE
    trainers = {dev: crr_online_trainer(torch, dev) for dev in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(21))
    states = {dev: copy_state(first, dev) for dev in trainers}
    rng = np.random.default_rng(22)
    reset_counts()
    worst_m = 0.0
    for _ in range(n):
        B = cfg["B"]
        cols = dict(s=rng.normal(0, 0.5, (B, cfg["D"])), ns=rng.normal(0, 0.5, (B, cfg["D"])),
                    a=np.eye(cfg["A"])[rng.integers(0, cfg["A"], B)], r=np.ones((B, 1)),
                    nt=(rng.random((B, 1)) > 0.05))
        t = {k: torch.tensor(v, dtype=torch.float32) for k, v in cols.items()}
        metrics = {}
        for dev, trainer in trainers.items():
            batch = rlt.DiscreteDqnInput(
                state=rlt.FeatureData(t["s"]), next_state=rlt.FeatureData(t["ns"]),
                reward=t["r"], time_diff=None, step=None, not_terminal=t["nt"],
                action=t["a"], next_action=t["a"],
                possible_actions_mask=torch.ones_like(t["a"]),
                possible_next_actions_mask=torch.ones_like(t["a"])).to(dev)
            states[dev], m = trainer.train_step(states[dev], batch)
            metrics[dev] = {k: v.cpu() for k, v in m.items()}
        for k, want in metrics["cpu"].items():
            torch.testing.assert_close(metrics[DEVICE][k], want, **AC_STEP_TOL, msg=k)
            worst_m = max(worst_m, (metrics[DEVICE][k] - want).abs().item())
    launches, plain_calls = read_counts()
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"CRR lockstep: launches {launches}, plain calls {plain_calls}")
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], AC_PARAM_TOL, "CRR")
    log(f"  CRR, card vs CPU, {n} lockstep train steps (minibatch {cfg['B']}, "
        f"{cfg['widths']} {cfg['act']}): metrics max abs {worst_m:.3e} (last q1_loss "
        f"{metrics[DEVICE]['q1_loss'].item():.6f}, actor_loss "
        f"{metrics[DEVICE]['actor_loss'].item():.6f}); {count} state tensors max abs "
        f"{worst_p:.3e}; K1-K5 launches 0, plain calls 0")
    return worst_m, worst_p


def crr_offline_job_phase(torch, tmp, epochs):
    """The flow of tests/test_offline_managers.py::test_crr_offline_e2e on
    the card: random CartPole rows (gymnasium where it imports, else the
    port's functional CartPole on the host), the timeline with a 95/5
    split, ``identify_and_train_network`` with the DiscreteCRR block for
    ``epochs`` epochs, the actor artifact against the in-process actor (its
    serving module, and ``actor_logits``, one K3 launch) on 64 raw rows, the
    greedy episodes through ``load_predictor``.  Train steps/s, the host's
    decode of a minibatch, a train step's CUDA kernels and the device's idle
    share (a profiled window), the mean reward (the bar read at 20 epochs
    only)."""
    import pandas as pd

    from reagent_tpu_torch.data.data_module import TableSpec, iterate_minibatches
    from reagent_tpu_torch.prediction.predictor_wrapper import load_predictor
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense
    from reagent_tpu_torch.workflow import gym_batch_rl
    from reagent_tpu_torch.workflow.training import identify_and_train_network

    cfg = CRR_OFFLINE
    have_gym = importlib.util.find_spec("gymnasium") is not None
    pkl, table = os.path.join(tmp, "crr_pre.pkl"), os.path.join(tmp, "crr_table.pkl")
    t0 = time.perf_counter()
    if have_gym:
        route = "gymnasium CartPole-v1"
        gym_batch_rl.offline_gym_random("CartPole-v1", pkl, cfg["transitions"],
                                        cfg["max_steps"], cfg["seed"])
    else:
        route = "the port's functional CartPole on the host"
        gym_batch_rl.random_rollouts(HostCartPole(cfg["max_steps"]), cfg["transitions"],
                                     cfg["seed"]).to_pickle(pkl)
    spec = TableSpec(table_name="cp", path=table, table_sample=cfg["split"][0],
                     eval_table_sample=cfg["split"][1])
    gym_batch_rl.timeline_operator(pkl, spec)
    df = pd.read_pickle(table)
    log(f"  env: {route}; {cfg['transitions']} random transitions and the timeline in "
        f"{time.perf_counter() - t0:.2f} s, {len(df)} rows")

    reset_counts()
    with capturing_manager(CRR_OFFLINE_MODEL) as captured:
        out = identify_and_train_network(spec, CRR_OFFLINE_MODEL, num_epochs=epochs,
                                         output_dir=os.path.join(tmp, "crr_out"), device=DEVICE)
    launches, plain_calls = read_counts()
    data = out.logger_data
    steps, secs = data["train_steps"], data["train_seconds"]
    log(f"  {steps} CRR train steps ({epochs} epochs) in {secs:.3f} s ({steps / secs:.2f} "
        f"steps/s, host decode and the reporter included), q1_loss "
        f"{out.training_report.td_loss}; eval_seconds {data['eval_seconds']} (no CPE for a "
        f"CRR trainer, as in JAX); K1-K5 launches {sum(launches.values())}, plain calls "
        f"{plain_calls}")
    if any(launches.values()) or plain_calls or out.training_report.cpe_details is not None:
        raise AssertionError(f"CRR job: launches {launches}, plain calls {plain_calls}")
    if not np.isfinite(out.training_report.td_loss):
        raise AssertionError(f"CRR job: q1_loss {out.training_report.td_loss}")

    trainer, tstate, _ = captured["build_serving_module_args"]
    serving, batch_pre = captured["build_serving_module"], captured["build_batch_preprocessor"]
    path = out.output_paths["default_model"]
    predictor = load_predictor(path)
    values, presence = sparse_to_dense(df["state_features"].tolist()[:64],
                                       predictor.sorted_features)
    artifact = np.concatenate([predictor.predict(
        {f: float(v) for f, v in zip(predictor.sorted_features, row)})[1] for row in values])
    v_t, p_t = (torch.tensor(x, device=DEVICE) for x in (values, presence))
    _, live = serving(v_t, p_t)
    reset_counts()
    k3_logits = trainer.actor_logits(tstate, serving.model.preprocessor(v_t, p_t))
    k3_launches, plain_calls = read_counts()
    live, k3_logits = live.cpu().numpy(), k3_logits.cpu().numpy()
    diff, diff_k3 = (float(np.abs(artifact - x).max()) for x in (live, k3_logits))
    with open(os.path.join(path, "manifest.json")) as f:
        acts = json.load(f)["activations"]
    log(f"  actor artifact: model_type {predictor.model_type!r}, activations {acts}; 64 raw "
        f"rows' logits against the in-process serving module max abs {diff:.3e}, against "
        f"actor_logits (K3, {k3_launches['fused_mlp_forward']} launch) {diff_k3:.3e}")
    if (predictor.model_type != "discrete_dqn" or artifact.shape != (64, 2)
            or k3_launches["fused_mlp_forward"] != 1 or plain_calls):
        raise AssertionError(f"CRR job: artifact {predictor.model_type} {artifact.shape}, "
                             f"K3 {k3_launches}, plain {plain_calls}")
    np.testing.assert_allclose(artifact, live, atol=1e-4, rtol=0)
    np.testing.assert_allclose(artifact, k3_logits, atol=1e-4, rtol=0)

    bs = CRR_OFFLINE_MODEL["DiscreteCRR"]["trainer_param"].get("minibatch_size", 512)
    frames = [b for b, _ in zip(iterate_minibatches(df, bs, seed=0), range(8))]
    decode_ms = []
    for frame in frames:
        t0 = time.perf_counter()
        batch_pre(frame)
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    batches = [batch_pre(frame) for frame in frames]

    def run(state=tstate):
        for batch in batches:
            state, _ = trainer.train_step(state, batch)
        return state

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    step_us = (time.perf_counter() - t0) / len(batches) * 1e6
    dev_us, kernels = profile_loop(torch, run, len(batches), step_us, "CRR train")
    decode = statistics.median(decode_ms)
    log(f"  a CRR train step {step_us / 1e3:.3f} ms (pre-decoded), the host's decode of its "
        f"{bs}-row batch {decode:.3f} ms (median of {len(frames)}), {kernels:.1f} CUDA kernels "
        f"a step, on {card_line()}")

    t0 = time.perf_counter()
    if have_gym:
        mean = gym_batch_rl.evaluate_gym("CartPole-v1", path, cfg["episodes"],
                                         max_steps=cfg["max_steps"])
    else:
        mean = float(np.mean(gym_batch_rl.greedy_returns(
            predictor, HostCartPole(cfg["max_steps"]), cfg["episodes"])))
    full = epochs == cfg["full_epochs"]
    log(f"  {cfg['episodes']} greedy episodes of at most {cfg['max_steps']} steps ({route}) "
        f"through load_predictor in {time.perf_counter() - t0:.2f} s: mean reward {mean:.2f} "
        f"(the reference's bar {cfg['bar']}: {'met' if mean >= cfg['bar'] else 'missed'}"
        f"{'' if full else '; not held at the cut depth'})")
    if not np.isfinite(mean):
        raise AssertionError(f"CRR job: mean reward {mean}")
    return dict(steps=steps, steps_per_s=steps / secs, step_ms=step_us / 1e3, decode_ms=decode,
                device_us=dev_us, kernels_per_step=kernels,
                idle=1 - dev_us / step_us, mean_reward=mean, bar=cfg["bar"], epochs=epochs,
                k3_launches=k3_launches["fused_mlp_forward"], route=route)


def crr_online_phase(torch, steps):
    """Online CRR through the generic loop (``run_online_training``), as the
    reference's test runs it: a ReplayBuffer of 50,000 prefilled with 3,000
    random transitions, the actor's softmax acting through K3, one sample
    (K4) and one CRR update a step, minibatch 256; then a profiled window of
    10 steps (CUDA kernels a step, the device's idle share, host reads) and
    evaluate_policy over 20 greedy episodes of the actor through K3."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.replay import ReplayBuffer

    cfg = CRR_ONLINE
    env = CartPole(max_steps=200, device=DEVICE)
    trainer = crr_online_trainer(torch, DEVICE)
    tstate = trainer.init(torch.Generator().manual_seed(0))
    rb = ReplayBuffer(replay_capacity=cfg["capacity"], update_horizon=1, gamma=cfg["gamma"],
                      device=DEVICE)
    rb_state = rb.init(**example_transition(torch))
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    t0 = time.perf_counter()
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, cfg["prefill"])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    sampler = SoftmaxActionSampler(temperature=1.0)

    def policy_act(ts, obs, g):
        out = sampler.sample_action(trainer.actor_logits(ts, obs[None]), g)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    def greedy_act(ts, obs, g):
        return torch.argmax(trainer.actor_logits(ts, obs), dim=1).to(torch.int32)

    def loop(state, buffer, n):
        return run_online_training(
            env, trainer, state, rb, buffer, policy_act,
            lambda d: make_discrete_dqn_batch(d, cfg["A"]), gen,
            OnlineLoopConfig(num_steps=n, minibatch_size=cfg["B"]))

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate, rb_state, aux = loop(tstate, rb_state, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    losses = aux["td_losses"].cpu()
    log(f"  online CRR: prefill {cfg['prefill']} in {prefill_s:.2f} s; {steps} env steps + "
        f"{steps} updates in {wall:.3f} s = {steps / wall:.2f} env steps/s, episodes "
        f"{int(aux['episodes_completed'])}, last q1_loss {losses[-1].item():.6g}, launches "
        f"{launches}, plain calls {plain_calls}")
    for kernel in ("nstep_rewards", "fused_mlp_forward"):
        if launches[kernel] != steps:
            raise AssertionError(f"online CRR: {kernel} launched {launches[kernel]} times for "
                                 f"{steps} steps")
    if plain_calls or losses.shape != (steps,) or not torch.isfinite(losses).all():
        raise AssertionError(f"online CRR: plain calls {plain_calls}, losses {losses.shape}")
    n = 10
    ported = {}
    dev_us, kernels = profile_loop(torch, lambda: loop(tstate, rb_state, n), n,
                                   wall / steps * 1e6, "online CRR", ported)
    reset_counts()
    t0 = time.perf_counter()
    returns = evaluate_policy(env, greedy_act, tstate, gen, num_episodes=EVAL_EPISODES).cpu()
    eval_launches, plain_calls = read_counts()
    mean = returns.mean().item()
    full = steps == cfg["full_steps"]
    log(f"  evaluate_policy: {EVAL_EPISODES} greedy episodes of the actor in "
        f"{time.perf_counter() - t0:.2f} s, mean {mean:.2f} (the reference's bar "
        f"{cfg['bar']}: {'met' if mean >= cfg['bar'] else 'missed'}"
        f"{'' if full else '; not held at the cut depth'}), K3 launches "
        f"{eval_launches['fused_mlp_forward']}, on {card_line()}")
    if eval_launches["fused_mlp_forward"] != env.max_steps or plain_calls:
        raise AssertionError(f"online CRR eval: launches {eval_launches}, plain {plain_calls}")
    return dict(launches=launches, eval_launches=eval_launches, steps=steps,
                steps_per_s=steps / wall, device_us=dev_us, kernels_per_step=kernels,
                k3_us=ported["fused_mlp"], k4_us=ported["nstep"],
                idle=1 - dev_us / (wall / steps * 1e6), mean_reward=mean, bar=cfg["bar"])


def pg_trainer(torch, name, device):
    """The reference config's REINFORCE or PPO trainer on ``device``."""
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training.ppo_trainer import PPOTrainer
    from reagent_tpu_torch.training.reinforce_trainer import ReinforceTrainer

    cfg = PG_CONFIGS[name]
    net = FullyConnectedDQN(state_dim=4, action_dim=2, sizes=cfg["widths"],
                            activations=["leaky_relu"] * len(cfg["widths"]))
    cls = ReinforceTrainer if name == "REINFORCE" else PPOTrainer
    return cls(scorer=net, sampler=SoftmaxActionSampler(temperature=1.0),
               optimizer=cfg["optimizer"], device=device, **cfg["kw"])


def act_log_prob_err(torch, trainer, state, ep):
    """The episode's log-probs, each from one K3 launch at [1, 4], against
    the sampler's log-probs of K3's plain version's scores for the same
    observations, parameters and actions: rtol 1e-5, atol 1e-5 (float32
    sums in another order).  Max abs."""
    from reagent_tpu_torch.ops import fused_mlp

    net, params = trainer.scorer, state.policy_params
    weights = [(params[f"net.layers.{i}.weight"].T, params[f"net.layers.{i}.bias"])
               for i in range(len(net.net.layers))]
    scores = fused_mlp.fused_mlp_forward_reference(ep.state.float_features, weights,
                                                   net.activations)
    want = trainer.sampler.log_prob(scores, ep.action)
    torch.testing.assert_close(ep.log_prob, want, rtol=1e-5, atol=1e-5, msg="act log-probs")
    return (ep.log_prob - want).abs().max().item()


def pg_lockstep_phase(torch, name, episodes=3):
    """``episodes`` episodes of collection and training with the config's
    trainer on the card and on the CPU from one state and one noise tape
    (numpy reset uniforms and gumbel draws): actions, alive masks and
    returns exactly, each step's losses to rtol 1e-4, atol 1e-5, every state
    tensor to rtol 1e-3, atol 1e-4 (``AC_STEP_TOL``, ``AC_PARAM_TOL``).  The
    card's act steps are K3 launches, the CPU's K3's plain version: the
    card's log-probs are held to the plain version's on the card's own
    parameters (``act_log_prob_err``) and, in the first episode, where both
    sides start from one state, to the CPU's, each at rtol 1e-5, atol 1e-5."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.episodic import collect_episode
    from reagent_tpu_torch.gym.policies import discrete_q_scorer

    trainers = {dev: pg_trainer(torch, name, dev) for dev in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(31))
    states = {dev: copy_state(first, dev) for dev in trainers}
    envs = {dev: CartPole(max_steps=PG_MAX_STEPS, device=dev) for dev in trainers}
    rng = np.random.default_rng(32)
    worst_m, worst_lp, returns = 0.0, 0.0, []
    launches = plain_calls = None
    for episode in range(episodes):
        u = rng.random(4).astype(np.float32)
        g = -np.log(-np.log(np.maximum(rng.random((PG_MAX_STEPS, 2)), 1e-30))).astype(np.float32)
        out = {}
        for dev, trainer in trainers.items():
            noise = (torch.tensor(u, device=dev), torch.tensor(g, device=dev))
            if dev == DEVICE:
                reset_counts()
            ep, ret = collect_episode(envs[dev], discrete_q_scorer(trainer.scorer),
                                      trainer.sampler, states[dev].policy_params,
                                      PG_MAX_STEPS, noise=noise)
            if dev == DEVICE:
                launches, plain_calls = read_counts()
                worst_lp = max(worst_lp, act_log_prob_err(torch, trainer, states[dev], ep))
            states[dev], m = trainer.train_step(states[dev], ep)
            out[dev] = (ep.to("cpu"), float(ret), {k: v.cpu() for k, v in m.items()})
        (ep_c, ret_c, m_c), (ep_g, ret_g, m_g) = out["cpu"], out[DEVICE]
        torch.testing.assert_close(ep_g.action, ep_c.action, rtol=0, atol=0, msg="actions")
        torch.testing.assert_close(ep_g.valid_mask, ep_c.valid_mask, rtol=0, atol=0,
                                   msg="alive mask")
        if ret_g != ret_c:
            raise AssertionError(f"{name}: returns {ret_g} on the card, {ret_c} on the CPU")
        if episode == 0:
            torch.testing.assert_close(ep_g.log_prob, ep_c.log_prob, rtol=1e-5, atol=1e-5,
                                       msg="first episode's log-probs, card vs CPU")
            worst_lp = max(worst_lp, (ep_g.log_prob - ep_c.log_prob).abs().max().item())
        for k, want in m_c.items():
            torch.testing.assert_close(m_g[k], want, **AC_STEP_TOL, msg=k)
            worst_m = max(worst_m, (m_g[k] - want).abs().item())
        returns.append(ret_g)
        if launches["fused_mlp_forward"] != PG_MAX_STEPS or plain_calls:
            raise AssertionError(f"{name}: an episode's launches {launches}, plain "
                                 f"{plain_calls}")
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], AC_PARAM_TOL, name)
    log(f"  {name}, card vs CPU, {episodes} episodes from one noise tape: returns {returns} "
        f"on both, actions and alive masks equal; act log-probs (K3) max abs {worst_lp:.3e}; "
        f"metrics max abs {worst_m:.3e}; {count} state "
        f"tensors max abs {worst_p:.3e}; K3 {PG_MAX_STEPS} launches an episode")
    return worst_m, worst_p


def pg_run_phase(torch, name, episodes):
    """``episodes`` episodes of the config (each collected with the current
    policy through K3 and trained on), then a profiled episode and update
    (CUDA kernels, the device's idle share, host reads: 0 or the script
    fails) and evaluate_policy over 20 greedy episodes through K3."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.episodic import make_episodic_trainer_step
    from reagent_tpu_torch.gym.online_loop import evaluate_policy
    from reagent_tpu_torch.gym.policies import discrete_q_scorer

    cfg = PG_CONFIGS[name]
    trainer = pg_trainer(torch, name, DEVICE)
    state = trainer.init(torch.Generator().manual_seed(0))
    env = CartPole(max_steps=PG_MAX_STEPS, device=DEVICE)
    greedy = discrete_q_scorer(trainer.scorer)
    step = make_episodic_trainer_step(env, greedy, trainer.sampler, trainer, PG_MAX_STEPS)
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rets = []
    for _ in range(episodes):
        state, ret, _ = step(state, gen)
        rets.append(ret)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    rets = torch.stack(rets).cpu()
    per_episode = launches["fused_mlp_forward"] / episodes
    log(f"  {name}: {episodes} episodes of {PG_MAX_STEPS} steps (padded) and updates in "
        f"{wall:.3f} s = {episodes / wall:.2f} episodes/s, {episodes * PG_MAX_STEPS / wall:.1f} "
        f"env steps/s ({int(rets.sum())} of them alive), returns first {rets[:3].tolist()} "
        f"last {rets[-3:].tolist()}; K3 {per_episode:.1f} launches an episode, plain calls "
        f"{plain_calls}")
    if per_episode != PG_MAX_STEPS or plain_calls or any(
            v for k, v in launches.items() if k != "fused_mlp_forward"):
        raise AssertionError(f"{name}: launches {launches}, plain calls {plain_calls}")

    state_p, ported = state, {}
    dev_us, kernels = profile_loop(torch, lambda: step(state_p, gen), 1, wall / episodes * 1e6,
                                   f"{name} episode", ported)
    def greedy_act(ts, obs, g):
        return torch.argmax(greedy(ts.policy_params, obs), dim=1).to(torch.int32)

    reset_counts()
    returns = evaluate_policy(env, greedy_act, state, torch.Generator(device=DEVICE)
                              .manual_seed(2), num_episodes=EVAL_EPISODES).cpu()
    eval_launches, plain_calls = read_counts()
    mean = returns.mean().item()
    full = episodes == cfg["full_episodes"]
    log(f"  {name} evaluate_policy: {EVAL_EPISODES} greedy episodes, mean {mean:.2f} (the "
        f"reference's bar {cfg['bar']}: {'met' if mean >= cfg['bar'] else 'missed'}"
        f"{'' if full else '; not held at the cut depth'}), K3 launches "
        f"{eval_launches['fused_mlp_forward']}, on {card_line()}")
    if eval_launches["fused_mlp_forward"] != env.max_steps or plain_calls:
        raise AssertionError(f"{name} eval: launches {eval_launches}, plain {plain_calls}")
    return dict(launches=launches, eval_launches=eval_launches, episodes=episodes,
                episodes_per_s=episodes / wall, env_steps_per_s=episodes * PG_MAX_STEPS / wall,
                k3_per_episode=per_episode, device_us=dev_us, kernels_per_episode=kernels,
                k3_us=ported["fused_mlp"],
                idle=1 - dev_us / (wall / episodes * 1e6), mean_reward=mean, bar=cfg["bar"])


# ---------------------------------- the rest of the DQN family: C51, parametric

# tests/test_gym_all_algos.py:76-94 (discrete_c51_cartpole_online.yaml): 128,
# 64 leaky_relu, 51 atoms on 0..200, gamma 0.99, tau 0.2, Adam 3e-3; prefill
# 3,000 into a ReplayBuffer of 50,000, minibatch 256, 15,000 steps; and
# :120-147, :261-288 (parametric_dqn / parametric_sarsa_cartpole_online.yaml):
# a critic 128, 64 leaky_relu over (state, one-hot action), gamma 0.99, tau
# 0.1, Adam 1e-3 with amsgrad, prefill 10,000, minibatch 512, 20,000 steps;
# each bar 100 over 20 greedy episodes.  Cut here to ``prefill`` and ``steps``.
DQN_FAMILY_ONLINE = {
    "C51": dict(widths=[128, 64], act="leaky_relu", atoms=51, qmin=0, qmax=200, B=256,
                gamma=0.99, tau=0.2, optimizer={"Adam": {"lr": 0.003}}, maxq=True,
                prefill=1000, full_prefill=3000, steps=150, full_steps=15_000),
    "parametric DQN": dict(widths=[128, 64], act="leaky_relu", B=512, gamma=0.99, tau=0.1,
                           optimizer={"Adam": {"lr": 0.001, "amsgrad": True}}, maxq=True,
                           prefill=1000, full_prefill=10_000, steps=150, full_steps=20_000),
    "parametric SARSA": dict(widths=[128, 64], act="leaky_relu", B=512, gamma=0.99, tau=0.1,
                             optimizer={"Adam": {"lr": 0.001, "amsgrad": True}}, maxq=False,
                             prefill=1000, full_prefill=10_000, steps=150, full_steps=20_000),
}
DQN_FAMILY_CAPACITY, DQN_FAMILY_BAR = 50_000, 100.0
# the offline managers at the JAX tests' configs: tests/test_model_managers_all.py:
# 75-96 (3,000 random CartPole transitions, seed 11, a 95/5 split, 2 epochs)
# and tests/test_offline_managers.py:59-75 (10,000, seed 3, 95/5, 10 epochs);
# cut here to ``epochs``
DQN_FAMILY_OFFLINE = {
    "C51": dict(transitions=3000, seed=11, epochs=2, full_epochs=2, model={"DiscreteC51DQN": {
        "trainer_param": {"actions": ["0", "1"],
                          "rl": {"gamma": 0.99, "target_update_rate": 0.1},
                          "optimizer": {"Adam": {"lr": 0.002}}, "minibatch_size": 512},
        "net_builder": {"Categorical": {"sizes": [64, 64], "activations": ["relu", "relu"],
                                        "num_atoms": 21, "qmin": 0.0, "qmax": 200.0}}}}),
    "parametric DQN": dict(transitions=10_000, seed=3, epochs=2, full_epochs=10,
                           model={"ParametricDQN": {
                               "trainer_param": {
                                   "actions": ["0", "1"],
                                   "rl": {"gamma": 0.99, "target_update_rate": 0.1},
                                   "optimizer": {"Adam": {"lr": 0.003}}},
                               "net_builder": {"FullyConnected": {
                                   "sizes": [64, 64], "activations": ["relu", "relu"]}}}}),
}
# K3's forwards on these paths: the act step and evaluate_policy of C51
# (4 -> 128 -> 64 -> A * N logits) and of the parametric scorer (each state
# tiled against both one-hot actions: 6 -> 128 -> 64 -> 1); K4 at C51's
# minibatch (the parametric loops sample at K4_SHAPES["loop"])
K3_FAMILY_SHAPES = {
    "C51 act [1, 4->128->64->102]": (1, [4, 128, 64, 102]),
    "C51 eval [20, 4->128->64->102]": (EVAL_EPISODES, [4, 128, 64, 102]),
    "parametric act [2, 6->128->64->1]": (2, [6, 128, 64, 1]),
    "parametric eval [40, 6->128->64->1]": (2 * EVAL_EPISODES, [6, 128, 64, 1]),
}
K4_FAMILY_SHAPE = ("C51 loop", (50_000, 256, 1))  # capacity, B, H


def dqn_family_trainer(torch, name, device):
    """The online job's trainer, and its scorer ``(state, obs [B, 4]) -> Q
    [B, 2]`` (E[Z] of C51's distributions; the parametric scorer's tiled
    rows), each one K3 launch on the card."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.gym.policies import parametric_dqn_scorer
    from reagent_tpu_torch.models.categorical_dqn import CategoricalDQN
    from reagent_tpu_torch.models.critic import FullyConnectedCritic
    from reagent_tpu_torch.training.c51_trainer import C51Trainer
    from reagent_tpu_torch.training.parametric_dqn_trainer import ParametricDQNTrainer

    cfg = DQN_FAMILY_ONLINE[name]
    acts = [cfg["act"]] * len(cfg["widths"])
    rl = RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"],
                      maxq_learning=cfg["maxq"])
    if name == "C51":
        net = CategoricalDQN(state_dim=4, action_dim=2, num_atoms=cfg["atoms"], qmin=cfg["qmin"],
                             qmax=cfg["qmax"], sizes=cfg["widths"], activations=acts)
        trainer = C51Trainer(net, rl=rl, optimizer=cfg["optimizer"], device=device)
        return trainer, trainer.q_values
    net = FullyConnectedCritic(state_dim=4, action_dim=2, sizes=cfg["widths"], activations=acts)
    trainer = ParametricDQNTrainer(net, rl=rl, optimizer=cfg["optimizer"], device=device)
    scorer = parametric_dqn_scorer(2, trainer.q_network)
    return trainer, lambda ts, obs: scorer(ts.q_params, obs)


def dqn_family_batch(torch, name, cols, device):
    """One numpy-made batch of CartPole-like rows as the job's batch type."""
    from reagent_tpu_torch.core import types as rlt

    t = {k: torch.tensor(v, dtype=torch.float32) for k, v in cols.items()}
    ones = torch.ones_like(t["a"])
    common = dict(state=rlt.FeatureData(t["s"]), next_state=rlt.FeatureData(t["ns"]),
                  reward=t["r"], time_diff=torch.ones_like(t["r"]), step=None,
                  not_terminal=t["nt"])
    if name == "C51":
        batch = rlt.DiscreteDqnInput(action=t["a"], next_action=t["na"],
                                     possible_actions_mask=ones,
                                     possible_next_actions_mask=ones, **common)
    else:
        tiled = rlt.FeatureData(torch.eye(2).repeat(t["a"].shape[0], 1))
        batch = rlt.ParametricDqnInput(
            action=rlt.FeatureData(t["a"]), next_action=rlt.FeatureData(t["na"]),
            possible_actions=tiled, possible_actions_mask=ones, possible_next_actions=tiled,
            possible_next_actions_mask=ones, **common)
    return batch.to(device)


def dqn_family_lockstep_phase(torch, name, n=5):
    """``n`` train steps of the online job's trainer at its widths and
    minibatch on the card and on the CPU from one state, on the same numpy
    batches (CartPole-like states, logged actions and next actions, rewards
    of 1, a few terminals): each step's metrics to rtol 1e-4, atol 1e-5,
    every state tensor to rtol 1e-3, atol 1e-4, the integer leaves exactly
    (``AC_STEP_TOL``, ``AC_PARAM_TOL``, as phases 27 and 29).  The train
    steps' forwards are autograd modules: no K1-K5 launch."""
    cfg = DQN_FAMILY_ONLINE[name]
    trainers = {dev: dqn_family_trainer(torch, name, dev)[0] for dev in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(31))
    states = {dev: copy_state(first, dev) for dev in trainers}
    rng = np.random.default_rng(32)
    reset_counts()
    worst_m = 0.0
    for _ in range(n):
        B = cfg["B"]
        cols = dict(s=rng.normal(0, 0.5, (B, 4)), ns=rng.normal(0, 0.5, (B, 4)),
                    a=np.eye(2)[rng.integers(0, 2, B)], na=np.eye(2)[rng.integers(0, 2, B)],
                    r=np.ones((B, 1)), nt=(rng.random((B, 1)) > 0.05))
        metrics = {}
        for dev, trainer in trainers.items():
            states[dev], m = trainer.train_step(
                states[dev], dqn_family_batch(torch, name, cols, dev))
            metrics[dev] = {k: v.cpu() for k, v in m.items()}
        for k, want in metrics["cpu"].items():
            torch.testing.assert_close(metrics[DEVICE][k], want, **AC_STEP_TOL, msg=k)
            worst_m = max(worst_m, (metrics[DEVICE][k] - want).abs().item())
    launches, plain_calls = read_counts()
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"{name} lockstep: launches {launches}, plain calls {plain_calls}")
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], AC_PARAM_TOL, name)
    log(f"  {name}, card vs CPU, {n} train steps (minibatch {cfg['B']}, {cfg['widths']} "
        f"{cfg['act']}): metrics max abs {worst_m:.3e} (last td_loss "
        f"{metrics[DEVICE]['td_loss'].item():.6f}); {count} state tensors max abs "
        f"{worst_p:.3e}; K1-K5 launches 0, plain calls 0")
    return worst_m, worst_p


def k4_shape_times(torch, name, label, shape, timed=True):
    """K4 at ``shape`` (capacity, B, H) against its plain version (exact)
    and, where ``timed``, its CUDA-event time beside the bound from this
    run's inputs (else None)."""
    from reagent_tpu_torch.ops import nstep_replay

    capacity, B, H = shape
    rewards, terminals, idx = k4_inputs(torch, capacity, B, 7)
    got = nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99)
    for a, b in zip(got, nstep_replay.nstep_rewards_reference(rewards, terminals, idx, H, 0.99)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if not timed:
        log(f"  K4 {label} (capacity {capacity}, B {B}, H {H}): exact against the plain version")
        return None
    walked = int(got[1].sum())  # this run's windows, as far as each is read
    flops, nbytes = 2.0 * walked, 8.0 * B + 5.0 * walked + 9.0 * B
    b_ms, b_by = roofline(flops, nbytes, name)
    t = dict(
        ms=time_ms(torch, lambda: nstep_replay.nstep_rewards(rewards, terminals, idx, H, 0.99)),
        plain_ms=time_ms(torch, lambda: nstep_replay.nstep_rewards_reference(
            rewards, terminals, idx, H, 0.99)),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0)
    log(f"  K4 {label} (capacity {capacity}, B {B}, H {H}): exact; kernel {t['ms']:.4f} ms, "
        f"plain {t['plain_ms']:.4f} ms, bound {b_ms:.7f} ms ({b_by}), on {card_line()}")
    return t


def k3_k4_family_phase(torch, name, launch_floor_ms):
    """K3 at the new paths' four shapes against its plain version (rtol
    1e-5, atol 1e-5, as phase 8; the resident route each time: the largest
    net is 61 KB) and K4 at C51's minibatch (exact), each timed with CUDA
    events (3 warm-ups, median of 20) beside the launch floor and the bound
    from this run's inputs; ``{"K3": {shape: times}, "K4": {...}}``."""
    from reagent_tpu_torch.ops import fused_mlp, nstep_replay

    out = {"K3": {}, "K4": {}}
    for label, (rows, sizes) in K3_FAMILY_SHAPES.items():
        x, weights, acts = k3_eval_inputs(torch, rows, sizes, 50 + rows)
        if not fused_mlp.takes_resident_route(rows, weights):
            raise AssertionError(f"K3 {label}: not on the resident route")
        y = fused_mlp.fused_mlp_forward(x, weights, acts)
        yp = fused_mlp.fused_mlp_forward_reference(x, weights, acts)
        torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-5)
        macs = sum(i * o for i, o in zip(sizes[:-1], sizes[1:]))
        flops = 2.0 * rows * macs
        nbytes = 4.0 * (rows * sizes[0] + macs + sum(sizes[1:]) + rows * sizes[-1])
        b_ms, b_by = roofline(flops, nbytes, name)
        plain_w = [(w.contiguous(), b) for w, b in weights]  # timed without its copies
        out["K3"][label] = t = dict(
            ms=time_ms(torch, lambda: fused_mlp.fused_mlp_forward(x, weights, acts)),
            plain_ms=time_ms(torch, lambda: fused_mlp.fused_mlp_forward_reference(
                x, plain_w, acts)),
            bound_ms=b_ms, bound_by=b_by, max_abs_err=(y - yp).abs().max().item(),
            route="resident")
        log(f"  K3 {label} (resident route): kernel {t['ms']:.4f} ms (launch floor "
            f"{launch_floor_ms:.4f}), plain {t['plain_ms']:.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}; {flops:.4g} FLOP, {nbytes:.4g} B), max abs {t['max_abs_err']:.3e}, "
            f"on {card_line()}")
    label, shape = K4_FAMILY_SHAPE
    out["K4"][label] = k4_shape_times(torch, name, label, shape)
    return out


def dqn_family_online_phase(torch, name, steps, prefill):
    """One online job through the generic loop (``run_online_training``), as
    the reference's test runs it: a ReplayBuffer of 50,000 prefilled with
    ``prefill`` random transitions, softmax acting on the scorer (K3), one
    sample (K4) and one update a step; then a profiled window of 10 steps
    (CUDA kernels a step, the device's idle share, host reads: 0 or the
    script fails) and evaluate_policy over 20 greedy episodes through K3."""
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler
    from reagent_tpu_torch.gym.preprocessors import (
        make_discrete_dqn_batch,
        make_parametric_dqn_batch,
    )
    from reagent_tpu_torch.replay import ReplayBuffer

    cfg = DQN_FAMILY_ONLINE[name]
    env = CartPole(max_steps=200, device=DEVICE)
    trainer, q_values = dqn_family_trainer(torch, name, DEVICE)
    tstate = trainer.init(torch.Generator().manual_seed(0))
    rb = ReplayBuffer(replay_capacity=DQN_FAMILY_CAPACITY, update_horizon=1,
                      gamma=cfg["gamma"], device=DEVICE)
    rb_state = rb.init(**example_transition(torch))
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    t0 = time.perf_counter()
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, prefill)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    sampler = SoftmaxActionSampler(temperature=1.0)
    make_batch = make_discrete_dqn_batch if name == "C51" else make_parametric_dqn_batch

    def policy_act(ts, obs, g):
        out = sampler.sample_action(q_values(ts, obs[None]), g)
        idx = torch.argmax(out.action[0]).to(torch.int32)
        return idx, idx

    def greedy_act(ts, obs, g):
        return torch.argmax(q_values(ts, obs), dim=1).to(torch.int32)

    def loop(state, buffer, n):
        return run_online_training(
            env, trainer, state, rb, buffer, policy_act, lambda d: make_batch(d, 2), gen,
            OnlineLoopConfig(num_steps=n, minibatch_size=cfg["B"]))

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tstate, rb_state, aux = loop(tstate, rb_state, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    losses = aux["td_losses"].cpu()
    log(f"  online {name}: prefill {prefill} in {prefill_s:.2f} s; {steps} env steps + "
        f"{steps} updates in {wall:.3f} s = {steps / wall:.2f} env steps/s, episodes "
        f"{int(aux['episodes_completed'])}, last td_loss {losses[-1].item():.6g}, launches "
        f"{launches}, plain calls {plain_calls}")
    for kernel in ("nstep_rewards", "fused_mlp_forward"):
        if launches[kernel] != steps:
            raise AssertionError(f"online {name}: {kernel} launched {launches[kernel]} times "
                                 f"for {steps} steps")
    others = {k: v for k, v in launches.items() if k not in ("nstep_rewards", "fused_mlp_forward")}
    if (any(others.values()) or plain_calls or losses.shape != (steps,)
            or not torch.isfinite(losses).all()):
        raise AssertionError(f"online {name}: launches {others}, plain calls {plain_calls}, "
                             f"losses {losses.shape}")
    n = 10
    ported = {}
    dev_us, kernels = profile_loop(torch, lambda: loop(tstate, rb_state, n), n,
                                   wall / steps * 1e6, f"online {name}", ported)
    reset_counts()
    t0 = time.perf_counter()
    returns = evaluate_policy(env, greedy_act, tstate, gen, num_episodes=EVAL_EPISODES).cpu()
    eval_launches, plain_calls = read_counts()
    mean = returns.mean().item()
    full = steps == cfg["full_steps"]
    log(f"  evaluate_policy: {EVAL_EPISODES} greedy episodes in {time.perf_counter() - t0:.2f} "
        f"s, mean {mean:.2f} (the reference's bar {DQN_FAMILY_BAR}: "
        f"{'met' if mean >= DQN_FAMILY_BAR else 'missed'}"
        f"{'' if full else '; not held at the cut depth'}), K3 launches "
        f"{eval_launches['fused_mlp_forward']}, on {card_line()}")
    if eval_launches["fused_mlp_forward"] != env.max_steps or plain_calls:
        raise AssertionError(f"online {name} eval: launches {eval_launches}, "
                             f"plain {plain_calls}")
    return dict(launches=launches, eval_launches=eval_launches, steps=steps,
                steps_per_s=steps / wall, device_us=dev_us, kernels_per_step=kernels,
                k3_us=ported["fused_mlp"], k4_us=ported["nstep"],
                idle=1 - dev_us / (wall / steps * 1e6), mean_reward=mean, bar=DQN_FAMILY_BAR)


def dqn_family_offline_phase(torch, tmp, name, epochs):
    """One offline manager at the JAX test's config: random CartPole rows
    (gymnasium where it imports, else the port's functional CartPole on the
    host), the timeline with a 95/5 split, ``identify_and_train_network``
    for ``epochs`` epochs; train steps/s (host decode and the reporter
    included) and the finite ``td_loss``.  C51: the artifact's ``model.pt``
    against the in-process serving module and against ``q_values`` (one K3
    launch) on 64 raw rows, within 1e-4.  ParametricDQN: ``default_model`` is
    ``""`` (no artifact, as in JAX), and the in-process serving module
    against the parametric scorer (one K3 launch) on the same rows."""
    import pandas as pd

    from reagent_tpu_torch.data.data_module import TableSpec
    from reagent_tpu_torch.gym.policies import parametric_dqn_scorer
    from reagent_tpu_torch.prediction.predictor_wrapper import CategoricalDqnPredictorWrapper
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense
    from reagent_tpu_torch.workflow import gym_batch_rl
    from reagent_tpu_torch.workflow.training import identify_and_train_network

    cfg = DQN_FAMILY_OFFLINE[name]
    have_gym = importlib.util.find_spec("gymnasium") is not None
    tag = name.replace(" ", "_")
    pkl, table = os.path.join(tmp, f"{tag}_pre.pkl"), os.path.join(tmp, f"{tag}_table.pkl")
    t0 = time.perf_counter()
    if have_gym:
        route = "gymnasium CartPole-v1"
        gym_batch_rl.offline_gym_random("CartPole-v1", pkl, cfg["transitions"], 200, cfg["seed"])
    else:
        route = "the port's functional CartPole on the host"
        gym_batch_rl.random_rollouts(HostCartPole(200), cfg["transitions"],
                                     cfg["seed"]).to_pickle(pkl)
    spec = TableSpec(table_name=tag, path=table, table_sample=95.0, eval_table_sample=5.0)
    gym_batch_rl.timeline_operator(pkl, spec)
    df = pd.read_pickle(table)
    log(f"  {name} env: {route}; {cfg['transitions']} random transitions and the timeline in "
        f"{time.perf_counter() - t0:.2f} s, {len(df)} rows")

    reset_counts()
    with capturing_manager(cfg["model"]) as captured:
        out = identify_and_train_network(spec, cfg["model"], num_epochs=epochs,
                                         output_dir=os.path.join(tmp, f"{tag}_out"),
                                         device=DEVICE)
    launches, plain_calls = read_counts()
    data = out.logger_data
    steps, secs, loss = data["train_steps"], data["train_seconds"], out.training_report.td_loss
    log(f"  offline {name}: {steps} train steps ({epochs} of the test's {cfg['full_epochs']} "
        f"epochs) in {secs:.3f} s = {steps / secs:.2f} steps/s (host decode and the reporter "
        f"included), td_loss {loss:.6g}; K1-K5 launches {sum(launches.values())}, plain calls "
        f"{plain_calls}, on {card_line()}")
    if (any(launches.values()) or plain_calls or not np.isfinite(loss)
            or out.training_report.cpe_details is not None):
        raise AssertionError(f"offline {name}: launches {launches}, plain {plain_calls}, "
                             f"td_loss {loss}")

    trainer, tstate, _ = captured["build_serving_module_args"]
    serving = captured["build_serving_module"]
    path = out.output_paths["default_model"]
    if name == "C51":
        pre = serving.preprocessor
        values, presence = sparse_to_dense(df["state_features"].tolist()[:64],
                                           pre.sorted_features)
        names, served = CategoricalDqnPredictorWrapper.load(path)(values, presence)
        v_t, p_t = (torch.tensor(x, device=DEVICE) for x in (values, presence))
        live = serving(v_t, p_t)[1]
        reset_counts()
        k3 = trainer.q_values(tstate, pre(v_t, p_t))
    else:
        if path != "":
            raise AssertionError(f"offline {name}: default_model {path!r}, not ''")
        pre = serving.model.state_preprocessor
        values, presence = sparse_to_dense(df["state_features"].tolist()[:64],
                                           pre.sorted_features)
        v_t, p_t = (torch.tensor(x, device=DEVICE) for x in (values, presence))
        eye = torch.eye(2, device=DEVICE).repeat(64, 1)
        names, live = serving(v_t.repeat_interleave(2, 0), p_t.repeat_interleave(2, 0), eye,
                              torch.ones_like(eye))
        live = live.reshape(64, 2)
        served = live.cpu().numpy()
        reset_counts()
        k3 = parametric_dqn_scorer(2, trainer.q_network)(tstate.q_params, pre(v_t, p_t))
    k3_launches, plain_calls = read_counts()
    live, k3 = live.cpu().numpy(), k3.cpu().numpy()
    diff, diff_k3 = (float(np.abs(served - x).max()) for x in (live, k3))
    log(f"  {name} serving: default_model {path!r}, names {names}; 64 raw rows' Q "
        f"({'the artifact' if path else 'in process'}) against the in-process module max "
        f"abs {diff:.3e}, against the trainer's forward through K3 "
        f"({k3_launches['fused_mlp_forward']} launch) {diff_k3:.3e}")
    if served.shape != (64, 2) or k3_launches["fused_mlp_forward"] != 1 or plain_calls:
        raise AssertionError(f"offline {name}: Q {served.shape}, K3 {k3_launches}, plain "
                             f"{plain_calls}")
    np.testing.assert_allclose(served, live, atol=1e-4, rtol=0)
    np.testing.assert_allclose(served, k3, atol=1e-4, rtol=0)
    return dict(steps=steps, steps_per_s=steps / secs, td_loss=loss, epochs=epochs,
                k3_launches=k3_launches["fused_mlp_forward"], route=route,
                default_model=path, artifact_err=diff, k3_err=diff_k3)


# ------------------------------------------ the rest of the unfused stack

# phase 37: every member the port once refused and every scheduler, at the
# full offline width's parameter shapes (the wide weights factor under
# Adafactor); card against CPU within these tolerances (float32 elementwise
# rules: one rsqrt or pow of the card's against the CPU's, and the card's
# reductions of Lamb's norms and Adafactor's means in another order)
OPTIMIZER_CONFIGS = {
    "RMSprop": {"RMSprop": {"lr": 0.01, "momentum": 0.9, "centered": True}},
    "Adagrad": {"Adagrad": {"lr": 0.05}},
    "Lion": {"Lion": {"lr": 0.001, "weight_decay": 0.1}},
    "Adadelta": {"Adadelta": {"lr": 1.0, "weight_decay": 0.01}},
    "Adamax": {"Adamax": {"lr": 0.01, "weight_decay": 0.05}},
    "NAdam": {"NAdam": {"lr": 0.01, "weight_decay": 0.05}},
    "RAdam": {"RAdam": {"lr": 0.01, "betas": [0.9, 0.9]}},
    "Rprop": {"Rprop": {"lr": 0.01}},
    "ASGD": {"ASGD": {"lr": 0.05, "weight_decay": 0.01}},
    "SparseAdam": {"SparseAdam": {"lr": 0.01}},
    "Lamb": {"Lamb": {"lr": 0.01, "weight_decay": 0.01}},
    "Adafactor": {"Adafactor": {}},
    "StepLR": {"Adam": {"lr": 0.01, "lr_scheduler": {"StepLR": {"step_size": 2, "gamma": 0.5}}}},
    "MultiStepLR": {"SGD": {"lr": 0.05, "momentum": 0.9, "lr_scheduler": {
        "MultiStepLR": {"milestones": [1, 3], "gamma": 0.3}}}},
    "ExponentialLR": {"AdamW": {"lr": 0.01, "lr_scheduler": {"ExponentialLR": {"gamma": 0.8}}}},
    "LinearLR": {"RMSprop": {"lr": 0.01, "lr_scheduler": {"LinearLR": {"total_iters": 3}}}},
    "CosineAnnealingLR": {"RAdam": {"lr": 0.01, "lr_scheduler": {
        "CosineAnnealingLR": {"T_max": 4}}}},
    "OneCycleLR": {"Lamb": {"lr": 0.01, "lr_scheduler": {
        "OneCycleLR": {"max_lr_factor": 5.0, "total_steps": 6, "pct_start": 0.5}}}},
}
OPT_TOL = dict(rtol=1e-5, atol=1e-6)
# phase 38: FullyConnectedNetwork's options at the full offline width
FCN_OPTIONS = dict(use_batch_norm=True, use_layer_norm=True, dropout_ratio=0.1,
                   use_skip_connections=True)
FCN_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
FCN_GRAD_TOL = 1e-4  # max |card - CPU| over the gradient's largest entry
OPTIONS_WORKFLOW_STEPS = 8


def full_width_params(torch, seed):
    """The full offline width's parameters, as the unfused trainer holds
    them ([out, in] weights and biases), from a numpy seed."""
    rng = np.random.default_rng(seed)
    sizes = [FULL["D"], *FULL["widths"], FULL["A"]]
    params = {}
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"net.layers.{i}.weight"] = rng.normal(0, np.sqrt(2 / n_in), (n_out, n_in))
        params[f"net.layers.{i}.bias"] = rng.normal(0, 0.1, n_out)
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in params.items()}


def optimizers_phase(torch, n=5):
    """Each of OPTIMIZER_CONFIGS' rules steps ``n`` times (RAdam 8, past
    its rectification threshold) on the card and on the CPU from the same
    parameters with the same gradients; every
    parameter and every optimizer state tensor (moments, counts, the
    schedule's count, Adafactor's row and column factors) compared
    (``OPT_TOL``, integer leaves exactly).  Adafactor must factor the
    [512, 128] and [256, 512] weights."""
    from reagent_tpu_torch.optim import make_optimizer

    params = full_width_params(torch, 70)
    rng = np.random.default_rng(71)
    grads = [{k: torch.tensor(rng.normal(size=v.shape) * 0.7 ** i, dtype=torch.float32)
              for k, v in params.items()} for i in range(n)]
    grads += [{k: torch.tensor(rng.normal(size=v.shape) * 0.7 ** (n + i), dtype=torch.float32)
               for k, v in params.items()} for i in range(3)]
    worst = {}
    for name, config in OPTIMIZER_CONFIGS.items():
        # RAdam (b2 0.9) rectifies from its 6th step: 8 steps where it runs
        steps = n + 3 if "RAdam" in config or name == "CosineAnnealingLR" else n
        out = {}
        for dev in ("cpu", DEVICE):
            opt = make_optimizer(config)
            p = {k: v.to(dev) for k, v in params.items()}
            state = opt.init(p)
            for g in grads[:steps]:
                p, state = opt.update({k: v.to(dev) for k, v in g.items()}, state, p)
            out[dev] = (p, state)
        count, err_p = compare_states(torch, out[DEVICE][0], out["cpu"][0], OPT_TOL, name)
        n_state, err_s = compare_states(torch, out[DEVICE][1], out["cpu"][1], OPT_TOL, name)
        worst[name] = max(err_p, err_s)
        moved = max((out["cpu"][0][k] - params[k]).abs().max().item() for k in params)
        if name == "Adafactor" and out["cpu"][1].v_row["net.layers.0.weight"].shape != (128,):
            raise AssertionError("Adafactor did not factor the [512, 128] weight")
        log(f"  {name}: {steps} steps, {count} parameters and {n_state} state tensors card vs "
            f"CPU max abs {worst[name]:.3e} (largest move {moved:.4g})")
    return worst


def fcn_options_phase(torch):
    """FullyConnectedNetwork(D=128, 512, 256, A=8) with FCN_OPTIONS on 4,096
    rows: the forward (running-average norms), the gradient of a weighted
    sum into every parameter (the batch norm's mean and var included), and
    the forward with ``training=True`` (batch statistics, running averages
    moved, one fed dropout mask per hidden layer), each card against the
    CPU from the same weights."""
    import copy

    from reagent_tpu_torch.models.fully_connected_network import FullyConnectedNetwork

    sizes = [FULL["D"], *FULL["widths"], FULL["A"]]
    acts = [FULL["act"]] * len(FULL["widths"]) + ["linear"]
    rng = np.random.default_rng(72)
    base = FullyConnectedNetwork(sizes, acts, generator=torch.Generator().manual_seed(3),
                                 **FCN_OPTIONS)
    with torch.no_grad():
        for name, p in base.named_parameters():
            if "norms" in name:
                noise = torch.tensor(rng.normal(0, 0.2, p.shape), dtype=torch.float32)
                p.copy_(p.abs() + noise.abs() + 0.5 if name.endswith(".var") else p + noise)
    x = torch.tensor(rng.normal(size=(FULL["B"], FULL["D"])), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(FULL["B"], FULL["A"])), dtype=torch.float32)
    masks = [torch.tensor(rng.random((FULL["B"], d)) > FCN_OPTIONS["dropout_ratio"])
             for d in FULL["widths"]]
    res = {}
    for dev in ("cpu", DEVICE):
        net = copy.deepcopy(base).to(dev)
        params = {k: v.detach().requires_grad_(True) for k, v in net.named_parameters()}
        out = torch.func.functional_call(net, params, (x.to(dev),))
        grads = torch.autograd.grad(torch.sum(out * w.to(dev)), list(params.values()))
        train_out = net(x.to(dev), training=True, dropout_masks=[m.to(dev) for m in masks])
        stats = {k: v.detach().cpu() for k, v in net.named_parameters()
                 if k.endswith((".mean", ".var"))}
        res[dev] = (out.detach().cpu(), dict(zip(params, (g.cpu() for g in grads))),
                    train_out.detach().cpu(), stats)
    (o_c, g_c, t_c, s_c), (o_g, g_g, t_g, s_g) = res["cpu"], res[DEVICE]
    torch.testing.assert_close(o_g, o_c, **FCN_FWD_TOL)
    torch.testing.assert_close(t_g, t_c, **FCN_FWD_TOL)
    for k in s_c:
        torch.testing.assert_close(s_g[k], s_c[k], **FCN_FWD_TOL, msg=k)
    worst_g = 0.0
    for k, want in g_c.items():
        rel = (g_g[k] - want).abs().max().item() / max(1.0, want.abs().max().item())
        if rel > FCN_GRAD_TOL:
            raise AssertionError(f"FCN options: gradient {k} card vs CPU {rel:.3e} of its scale")
        worst_g = max(worst_g, rel)
    bn_var = sum(g_c[k].abs().sum().item() for k in g_c if k.endswith(".var"))
    log(f"  FCN {sizes} {FCN_OPTIONS}, B {FULL['B']}: forward max abs "
        f"{(o_g - o_c).abs().max().item():.3e}, training=True (fed masks) "
        f"{(t_g - t_c).abs().max().item():.3e}, {len(g_c)} gradients within "
        f"{worst_g:.3e} of their scale (|d/d var| summed {bn_var:.4g}: the statistics train)")
    return max((o_g - o_c).abs().max().item(), (t_g - t_c).abs().max().item()), worst_g


def options_model():
    """The unfused DiscreteDQN at the full offline width with batch norm and
    dropout, RAdam and a cosine schedule over the run's 8 steps."""
    cfg = FULL
    return {"DiscreteDQN": {
        "trainer_param": {
            "actions": [str(a) for a in range(cfg["A"])],
            "rl": {"gamma": cfg["gamma"], "target_update_rate": cfg["tau"],
                   "maxq_learning": True},
            "double_q_learning": True,
            "minibatch_size": cfg["B"],
            "optimizer": {"RAdam": {"lr": cfg["lr"], "lr_scheduler": {
                "CosineAnnealingLR": {"T_max": OPTIONS_WORKFLOW_STEPS}}}},
        },
        "net_builder": {"FullyConnected": {
            "sizes": cfg["widths"], "activations": [cfg["act"]] * len(cfg["widths"]),
            "use_batch_norm": True, "dropout_ratio": 0.1}},
        "eval_parameters": {"calc_cpe_in_training": False},
    }}


def options_workflow_phase(torch, tmp):
    """identify_and_train_network on OPTIONS_WORKFLOW_STEPS full-width
    batches (8,192 rows, 4 epochs of the 90% split as phase 6) with
    ``options_model``: train steps/s with the host's decode, the finite
    td_loss, the trained batch-norm statistics moved off their init, the
    schedule's count, no K1-K5 launch in training (the net is not dense),
    and the artifact (the batch norm folded into each layer) against the
    in-process module on 64 raw rows within 1e-4."""
    reset_counts()
    out, df, serving, (trainer, tstate, _), _, wall = run_workflow(
        FULL, FULL_ROWS, FULL_EPOCHS, torch, tmp, "options_width", model=options_model())
    launches, plain_calls = read_counts()
    steps, secs = out.logger_data["train_steps"], out.logger_data["train_seconds"]
    td = out.training_report.td_loss
    moved = max(tstate.q_params[f"net.batch_norms.{i}.var"].sub(1.0).abs().max().item()
                for i in range(3))
    log(f"  options workflow: {steps} train steps in {secs:.3f} s = {steps / secs:.2f} steps/s "
        f"(host decode included), td_loss {td:.6g}, batch-norm var moved {moved:.3e}, "
        f"schedule count {int(tstate.opt_state.schedule_count)}; launches "
        f"{sum(launches.values())}, plain calls {plain_calls}; workflow {wall:.1f} s")
    if (steps != OPTIONS_WORKFLOW_STEPS or td is None or not np.isfinite(td) or moved == 0.0
            or int(tstate.opt_state.schedule_count) != steps or any(launches.values())
            or plain_calls):
        raise AssertionError(f"options workflow: steps {steps}, td {td}, moved {moved}, "
                             f"launches {launches}, plain {plain_calls}")
    diff = check_artifact(out, df, serving, torch)
    log(f"  options workflow: the artifact (batch norm folded) vs the in-process module on 64 "
        f"rows: max abs {diff:.3e}, on {card_line()}")
    return dict(steps=steps, steps_per_s=steps / secs, td_loss=td, artifact_err=diff)


# --------------------------------------------- online continuous control

# the reference CI's online Pendulum jobs (tests/test_gym_all_algos.py:
# 150-258): 64, 64 nets, gamma 0.99, tau 0.005, Adam 3e-3, minibatch 256,
# ReplayBuffer of 50,000, 10 greedy episodes; this script cuts each to a
# prefill of 500 and 100 steps with a profiled window of 5 (PERF.md §4;
# tools/continuous_control_jobs.py runs the reference's depths)
CONTINUOUS_JOBS = {
    "SAC": dict(actor="gaussian", act="relu", q2=True, value=False, temperature=0.2,
                prefill=500, full_prefill=1000, steps=100, full_steps=12_000, bar=-500.0),
    "TD3": dict(actor="deterministic", act="relu", q2=True, value=False,
                prefill=500, full_prefill=1000, steps=100, full_steps=12_000, bar=-750.0),
    "continuous CRR": dict(actor="gaussian", act="leaky_relu", q2=False, value=True,
                           temperature=0.3, prefill=500, full_prefill=10_000, steps=100,
                           full_steps=8000, bar=-500.0),
}
CONTINUOUS_PROFILED_STEPS = 5
CONTINUOUS_B, CONTINUOUS_CAPACITY, CONTINUOUS_EVAL_EPISODES = 256, 50_000, 10
ACTION_SCALE = 2.0  # the actor acts in [-1, 1]; Pendulum's torque is in [-2, 2]
# phase 40 runs this job on the PrioritizedReplayBuffer (uniform priorities)
PRIORITIZED_JOB = "TD3"
# K3 on these paths (label -> rows, sizes, activations, resident route
# expected, seed): the act steps and evaluate_policy's batch of 10; each held
# to the plain version, the first and the last timed
K3_CONTINUOUS_TIMED = ("gaussian act [1, 3->64->64->2]", "gaussian eval [10, 3->64->64->2]")
K3_CONTINUOUS_SHAPES = {
    "gaussian act [1, 3->64->64->2]": (1, [3, 64, 64, 2], ["relu", "relu", "linear"], True, 83),
    "TD3 act [1, 3->64->64->1]": (1, [3, 64, 64, 1], ["relu", "relu", "tanh"], True, 82),
    "CRR act [1, 3->64->64->2]": (1, [3, 64, 64, 2], ["leaky_relu", "leaky_relu", "linear"],
                                  True, 83),
    "gaussian eval [10, 3->64->64->2]": (CONTINUOUS_EVAL_EPISODES, [3, 64, 64, 2],
                                         ["relu", "relu", "linear"], True,
                                         80 + CONTINUOUS_EVAL_EPISODES + 2),
}


def continuous_trainer(torch, name, device):
    """The online job's trainer on ``device``."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.models.actor import FullyConnectedActor, GaussianFullyConnectedActor
    from reagent_tpu_torch.models.critic import FullyConnectedCritic
    from reagent_tpu_torch.models.value import ValueNetwork
    from reagent_tpu_torch.training.sac_trainer import CRRWeightFn, SACTrainer
    from reagent_tpu_torch.training.td3_trainer import TD3Trainer

    cfg = CONTINUOUS_JOBS[name]
    acts = [cfg["act"]] * 2
    if cfg["actor"] == "gaussian":
        actor = GaussianFullyConnectedActor(3, 1, [64, 64], acts)
    else:
        actor = FullyConnectedActor(3, 1, [64, 64], acts, exploration_variance=0.2)
    q1 = FullyConnectedCritic(3, 1, [64, 64], acts)
    q2 = FullyConnectedCritic(3, 1, [64, 64], acts) if cfg["q2"] else None
    kw = dict(rl=RLParameters(gamma=0.99, target_update_rate=0.005),
              q_network_optimizer={"Adam": {"lr": 3e-3}},
              actor_network_optimizer={"Adam": {"lr": 3e-3}}, device=device)
    if name == "TD3":
        return TD3Trainer(actor, q1, q2, **kw)
    if cfg["value"]:
        return SACTrainer(actor, q1, q2, value_network=ValueNetwork(3, [64, 64], acts),
                          value_network_optimizer={"Adam": {"lr": 3e-3}},
                          entropy_temperature=cfg["temperature"],
                          crr_config=CRRWeightFn(exponent_beta=1.0, exponent_clamp=20.0), **kw)
    return SACTrainer(actor, q1, q2, entropy_temperature=cfg["temperature"],
                      target_entropy=-1.0, **kw)


def continuous_transition(torch):
    return dict(observation=torch.zeros(3), action=torch.zeros(1), reward=torch.tensor(0.0),
                terminal=torch.tensor(False))


def continuous_lockstep_phase(torch, name, n=5):
    """``n`` train steps of the online job's trainer on the card and on the
    CPU from one state, on the same numpy batches (Pendulum-like states,
    actions in [-1, 1) as the loop stores them, rewards in (-16, 0]) and the
    same explicit noise: metrics and state tensors compared at phase 27's
    tolerances; no K1-K5 launch in a train step."""
    from reagent_tpu_torch.core import types as rlt

    trainers = {dev: continuous_trainer(torch, name, dev) for dev in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(61))
    states = {dev: copy_state(first, dev) for dev in trainers}
    rng = np.random.default_rng(62)
    B = CONTINUOUS_B
    reset_counts()
    worst_m = 0.0
    for _ in range(n):
        th = rng.uniform(-np.pi, np.pi, B)
        s = np.stack([np.cos(th), np.sin(th), rng.uniform(-8, 8, B)], 1)
        ns = s + rng.normal(0, 0.05, s.shape)
        cols = dict(s=s, ns=ns, a=rng.uniform(-1, 1, (B, 1)), r=-rng.uniform(0, 16, (B, 1)),
                    nt=np.ones((B, 1)))
        noise = rng.normal(size=(B, 1) if name == "TD3" else (2, B, 1))
        t = {k: torch.tensor(v, dtype=torch.float32) for k, v in cols.items()}
        metrics = {}
        for dev, trainer in trainers.items():
            batch = rlt.PolicyNetworkInput(
                state=rlt.FeatureData(t["s"]), next_state=rlt.FeatureData(t["ns"]),
                action=rlt.FeatureData(t["a"]), next_action=rlt.FeatureData(t["a"]),
                reward=t["r"], time_diff=None, step=None, not_terminal=t["nt"]).to(dev)
            states[dev], m = trainer.train_step(
                states[dev], batch, torch.tensor(noise, dtype=torch.float32, device=dev))
            metrics[dev] = {k: v.cpu() for k, v in m.items()}
        for k, want in metrics["cpu"].items():
            torch.testing.assert_close(metrics[DEVICE][k], want, **AC_STEP_TOL, msg=k)
            worst_m = max(worst_m, (metrics[DEVICE][k] - want).abs().max().item())
    launches, plain_calls = read_counts()
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"{name} lockstep: launches {launches}, plain calls {plain_calls}")
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], AC_PARAM_TOL, name)
    log(f"  {name}, card vs CPU, {n} train steps (minibatch {B}, 64, 64 "
        f"{CONTINUOUS_JOBS[name]['act']}): metrics max abs {worst_m:.3e} (last q1_loss "
        f"{metrics[DEVICE]['q1_loss'].item():.6f}); {count} state tensors max abs "
        f"{worst_p:.3e}; K1-K5 launches 0, plain calls 0")
    return worst_m, worst_p


def continuous_policy(torch, trainer):
    """(the act step, the greedy act) of an online job: the actor through
    ``functional.actor_act``, its dense trunk one K3 launch; the act step
    draws its standard-normal noise from the loop's generator."""
    from reagent_tpu_torch.training import functional

    actor = trainer.actor_network

    def policy_act(ts, obs, g):
        noise = torch.randn((1, 1), generator=g, device=obs.device)
        action = functional.actor_act(actor, ts.actor_params, obs[None], noise).action[0]
        return action * ACTION_SCALE, action

    def greedy_act(ts, obs, g):
        return functional.actor_act(actor, ts.actor_params, obs).action * ACTION_SCALE

    return policy_act, greedy_act


def continuous_online_phase(torch, name, steps, prefill, prioritized=False, device=None):
    """One online Pendulum job through the generic loop, as the reference's
    test runs it: ``prefill`` uniform random transitions, then ``steps`` env
    steps each with an act step (K3), a sample (K4) and an update,
    minibatch 256; on the ReplayBuffer, or on the PrioritizedReplayBuffer
    at uniform priorities (its stratified draw, then the same K4 rows).  On
    the card a profiled window of CONTINUOUS_PROFILED_STEPS steps follows
    (kernels a step, the idle share, host reads: 0 or the script fails;
    the stream synchronisations are printed) and evaluate_policy over
    10 greedy episodes through K3.  ``device`` "cpu" runs the same job on
    the CPU (the plain versions), untimed by CUDA."""
    from reagent_tpu_torch.gym.envs import Pendulum
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.preprocessors import make_policy_network_batch
    from reagent_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer

    dev = device or DEVICE
    on_card = dev != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = CONTINUOUS_JOBS[name]
    env = Pendulum(device=dev)
    trainer = continuous_trainer(torch, name, dev)
    tstate = trainer.init(torch.Generator().manual_seed(0))
    buffer_cls = PrioritizedReplayBuffer if prioritized else ReplayBuffer
    rb = buffer_cls(replay_capacity=CONTINUOUS_CAPACITY, update_horizon=1, gamma=0.99,
                    device=dev)
    rb_state = rb.init(**continuous_transition(torch))
    gen = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, prefill)
    sync()
    prefill_s = time.perf_counter() - t0
    policy_act, greedy_act = continuous_policy(torch, trainer)

    def loop(state, buffer, n):
        return run_online_training(
            env, trainer, state, rb, buffer, policy_act, make_policy_network_batch, gen,
            OnlineLoopConfig(num_steps=n, minibatch_size=CONTINUOUS_B))

    label = f"online {name}{' (prioritized replay)' if prioritized else ''}"
    reset_counts()
    sync()
    t0 = time.perf_counter()
    tstate, rb_state, aux = loop(tstate, rb_state, steps)
    sync()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    losses = aux["td_losses"].cpu()
    log(f"  {label}: prefill {prefill} in {prefill_s:.2f} s; {steps} env steps + {steps} "
        f"updates in {wall:.3f} s = {steps / wall:.2f} env steps/s, episodes "
        f"{int(aux['episodes_completed'])}, last q1_loss {losses[-1].item():.6g}, launches "
        f"{launches}, plain calls {plain_calls}")
    if losses.shape != (steps,) or not torch.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses.shape}")
    others = {k: v for k, v in launches.items() if k not in ("nstep_rewards", "fused_mlp_forward")}
    if on_card and (any(launches[k] != steps for k in ("nstep_rewards", "fused_mlp_forward"))
                    or any(others.values()) or plain_calls):
        raise AssertionError(f"{label}: launches {launches} for {steps} steps, plain calls "
                             f"{plain_calls}")
    result = dict(launches=launches, steps=steps, steps_per_s=steps / wall, prefill=prefill,
                  prioritized=prioritized, bar=cfg["bar"])
    if on_card:
        ported = {}
        n = CONTINUOUS_PROFILED_STEPS
        dev_us, kernels = profile_loop(torch, lambda: loop(tstate, rb_state, n), n,
                                       wall / steps * 1e6, label, ported)
        result.update(device_us=dev_us, kernels_per_step=kernels, k3_us=ported["fused_mlp"],
                      k4_us=ported["nstep"], idle=1 - dev_us / (wall / steps * 1e6),
                      host_reads=0)
    reset_counts()
    t0 = time.perf_counter()
    returns = evaluate_policy(env, greedy_act, tstate, gen,
                              num_episodes=CONTINUOUS_EVAL_EPISODES).cpu()
    eval_launches, plain_calls = read_counts()
    mean = returns.mean().item()
    full = steps == cfg["full_steps"]
    log(f"  evaluate_policy: {CONTINUOUS_EVAL_EPISODES} greedy episodes in "
        f"{time.perf_counter() - t0:.2f} s, mean {mean:.2f} (the reference's bar {cfg['bar']}: "
        f"{'met' if mean >= cfg['bar'] else 'missed'}"
        f"{'' if full else '; not held at the cut depth'}), K3 launches "
        f"{eval_launches['fused_mlp_forward']}{', on ' + card_line() if on_card else ''}")
    if on_card and (eval_launches["fused_mlp_forward"] != env.max_steps or plain_calls):
        raise AssertionError(f"{label} eval: launches {eval_launches}, plain {plain_calls}")
    result.update(eval_launches=eval_launches, mean_reward=mean)
    return result


# ------------------------------------------------------- the world-model slice

# the world-model string pipeline: tests/test_world_model_string_e2e.py
# (reference gym/tests/test_world_model.py, configs/world_model/
# discrete_dqn_string.yaml, bar 10.0): 512 random StringGame episodes of 6,
# MDN-RNN (16 hidden, 1 layer, 1 gaussian, Adam 3e-3), StateEmbedEnv, online
# DQN on [16 hidden | 2 raw] observations.  Phase 42 cuts the depth (the
# MDN-RNN's steps, the prefill, the DQN's steps, the greedy episodes) and
# keeps every width; tools/world_model_jobs.py runs the full_* depths
WORLD_MODEL = dict(episodes=512, T=6, hid=16, wm_lr=3e-3, widths=[64, 32], act="leaky_relu",
                   gamma=0.99, tau=0.2, lr=0.003, capacity=20_000, B=256, temperature=0.5,
                   wm_steps=50, prefill=500, steps=300, eval_episodes=5,
                   full_wm_steps=300, full_prefill=2000, full_steps=6000, full_eval_episodes=20,
                   extension_steps=3000, extensions=2, bar=10.0)
# OpenGridworld DQN: tests/test_gym_envs_extra.py:99 (discrete_dqn_open_gridworld.yaml)
GRIDWORLD_JOB = dict(widths=[64], act="leaky_relu", gamma=0.95, tau=0.2, lr=0.005,
                     capacity=20_000, B=256, temperature=0.5, prefill=500, steps=300,
                     eval_episodes=20, full_prefill=3000, full_steps=10_000,
                     full_eval_episodes=20, bar=0.9)
# the possible-actions-mask DQN: tests/test_functionality_mask.py:23
# (dqn_possible_actions_mask.yaml): random legal actions, a train step
# after the first 65, masked double-Q max targets
MASK_JOB = dict(widths=[64], act="relu", gamma=0.99, tau=0.2, lr=0.01, capacity=4096, B=128,
                train_after=64, steps=300, eval_episodes=10, full_steps=600,
                full_eval_episodes=10, bar=200.0)
WM_PROFILED_STEPS = 10
# K3's forwards on these paths (act steps and greedy evaluations) and K4's
# samples, timed in phase 42 (label -> rows, sizes, activations, resident, seed)
K3_WM_SHAPES = {
    "world-model act [1, 18->64->32->2]": (1, [18, 64, 32, 2],
                                           ["leaky_relu", "leaky_relu", "linear"], True, 91),
    "world-model eval [20, 18->64->32->2]": (20, [18, 64, 32, 2],
                                             ["leaky_relu", "leaky_relu", "linear"], True, 92),
    "gridworld act [1, 6->64->4]": (1, [6, 64, 4], ["leaky_relu", "linear"], True, 93),
    "gridworld eval [20, 6->64->4]": (20, [6, 64, 4], ["leaky_relu", "linear"], True, 94),
    "mask eval [10, 24->64->4]": (10, [24, 64, 4], ["relu", "linear"], True, 95),
}
K4_WM_SHAPES = {"world-model and gridworld loops": (20_000, 256, 1),
                "mask job": (4096, 128, 1)}  # capacity, B, H
# each timing queues a ~1 s sleep on the card (time_ms): the act steps' two
# shapes and K4's loop shape are timed, the others only checked
K3_WM_TIMED = ("world-model act [1, 18->64->32->2]", "gridworld act [1, 6->64->4]")
K4_WM_TIMED = ("world-model and gridworld loops",)
MDN_TOL = dict(loss=dict(rtol=1e-4, atol=1e-6), param=dict(rtol=5e-4, atol=5e-5))


def wm_dqn_trainer(torch, cfg, state_dim, action_dim, device):
    """A job's DQNTrainer (FullyConnectedDQN at ``cfg``'s widths, Adam,
    double-Q max targets) on ``device``, and its scorer ``(state, obs [B,
    D], mask=None) -> Q``: one K3 launch on the card
    (``training/functional.py::score``)."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.gym.policies import discrete_dqn_scorer
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training import DQNTrainer

    net = FullyConnectedDQN(state_dim=state_dim, action_dim=action_dim, sizes=cfg["widths"],
                            activations=[cfg["act"]] * len(cfg["widths"]))
    trainer = DQNTrainer(
        q_network=net, rl=RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"]),
        optimizer={"Adam": {"lr": cfg["lr"]}}, double_q_learning=True, device=device)
    scorer = discrete_dqn_scorer(trainer.q_network)
    return trainer, lambda ts, obs, mask=None: scorer(ts.q_params, obs, mask)


def string_episodes(torch, env, episodes, T, generator):
    """``episodes`` uniform-random StringGame episodes of ``T`` steps as one
    time-major ``MemoryNetworkInput`` [T, episodes, ...] (the JAX test's
    ``_collect_random_episodes``), stepped as one batch of envs."""
    from reagent_tpu_torch.core import types as rlt

    state, obs = env.reset(generator, batch_size=episodes)
    cols = []
    for _ in range(T):
        a = torch.randint(0, env.action_dim, (episodes,), generator=generator, device=env.device)
        state, next_obs, reward, done = env.step(state, a)
        cols.append((obs, torch.nn.functional.one_hot(a, env.action_dim).to(torch.float32),
                     next_obs, reward, done))
        obs = next_obs
    obs, act, next_obs, reward, done = (torch.stack(c) for c in zip(*cols))
    return rlt.MemoryNetworkInput(
        state=rlt.FeatureData(obs), next_state=rlt.FeatureData(next_obs),
        action=rlt.FeatureData(act), reward=reward, time_diff=torch.ones_like(reward),
        step=None, not_terminal=1.0 - done.to(torch.float32),
        valid_step=torch.full((episodes, 1), T, dtype=torch.int32, device=env.device))


def mdnrnn_trainer(torch, cfg, device, lr=None):
    from reagent_tpu_torch.core.parameters import MDNRNNTrainerParameters
    from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
    from reagent_tpu_torch.training.world_model import MDNRNNTrainer

    net = MemoryNetwork(state_dim=2, action_dim=2, num_hiddens=cfg["hid"], num_hidden_layers=1,
                        num_gaussians=1)
    return MDNRNNTrainer(net, MDNRNNTrainerParameters(learning_rate=lr or cfg["wm_lr"]),
                         device=device)


def discrete_job_policy(torch, q_values, temperature):
    """(the act step, the greedy act): softmax at ``temperature`` over the
    scorer's Q (K3) and the loop's generator; greedy over a batch of envs."""
    from reagent_tpu_torch.gym.policies import SoftmaxActionSampler

    sampler = SoftmaxActionSampler(temperature=temperature)

    def policy_act(ts, obs, g):
        idx = torch.argmax(sampler.sample_action(q_values(ts, obs[None]), g).action[0])
        return idx.to(torch.int32), idx.to(torch.int32)

    def greedy_act(ts, obs, g):
        return torch.argmax(q_values(ts, obs), dim=1).to(torch.int32)

    return policy_act, greedy_act


def online_dqn_job(torch, label, env, trainer, q_values, cfg, steps, prefill, eval_episodes,
                   dev, extensions=0, policies=None, batch_maker=None, prefill_act=None):
    """A DQN job through the generic loop (``run_online_training``), as the
    JAX test runs it: a ReplayBuffer of cfg["capacity"] prefilled with
    ``prefill`` random transitions, then ``steps`` env steps each with a
    softmax act step (K3), a sample (K4) and an update; on the card a
    profiled window (kernels a step, the idle share, host reads: 0 or the
    script fails); then ``evaluate_policy`` over ``eval_episodes`` greedy
    episodes (K3 once a step).  Up to ``extensions`` more runs of
    cfg["extension_steps"] while the greedy mean is under the bar (the
    string job's insurance, test_world_model_string_e2e.py:137).  A job
    with its own acting passes ``policies`` (the act step, the greedy act),
    ``batch_maker`` and ``prefill_act`` (``prefill_replay_buffer``'s
    ``act_fn``)."""
    from reagent_tpu_torch.gym.online_loop import (
        OnlineLoopConfig,
        evaluate_policy,
        prefill_replay_buffer,
        run_online_training,
    )
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.replay import ReplayBuffer

    on_card = dev != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tstate = trainer.init(torch.Generator().manual_seed(0))
    rb = ReplayBuffer(replay_capacity=cfg["capacity"], update_horizon=1, gamma=cfg["gamma"],
                      device=dev)
    rb_state = rb.init(observation=torch.zeros(env.observation_dim),
                       action=torch.tensor(0, dtype=torch.int32), reward=torch.tensor(0.0),
                       terminal=torch.tensor(False))
    gen = torch.Generator(device=dev).manual_seed(5)
    t0 = time.perf_counter()
    rb_state = prefill_replay_buffer(env, rb, rb_state, gen, prefill, act_fn=prefill_act)
    sync()
    prefill_s = time.perf_counter() - t0
    policy_act, greedy_act = policies or discrete_job_policy(torch, q_values, cfg["temperature"])
    batch_maker = batch_maker or (lambda d: make_discrete_dqn_batch(d, env.action_dim))

    def loop(state, buffer, n):
        return run_online_training(
            env, trainer, state, rb, buffer, policy_act, batch_maker, gen,
            OnlineLoopConfig(num_steps=n, minibatch_size=cfg["B"]))

    reset_counts()
    sync()
    t0 = time.perf_counter()
    tstate, rb_state, aux = loop(tstate, rb_state, steps)
    sync()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    losses = aux["td_losses"].cpu()
    log(f"  {label}: prefill {prefill} in {prefill_s:.2f} s; {steps} env steps + {steps} "
        f"updates in {wall:.3f} s = {steps / wall:.2f} env steps/s, episodes "
        f"{int(aux['episodes_completed'])}, last td_loss {losses[-1].item():.6g}, launches "
        f"{launches}, plain calls {plain_calls}")
    if losses.shape != (steps,) or not torch.isfinite(losses).all():
        raise AssertionError(f"{label}: losses {losses.shape}")
    others = {k: v for k, v in launches.items() if k not in ("nstep_rewards", "fused_mlp_forward")}
    if on_card and (any(launches[k] != steps for k in ("nstep_rewards", "fused_mlp_forward"))
                    or any(others.values()) or plain_calls):
        raise AssertionError(f"{label}: launches {launches} for {steps} steps, plain calls "
                             f"{plain_calls}")
    result = dict(launches=launches, steps=steps, steps_per_s=steps / wall, prefill=prefill,
                  prefill_s=prefill_s, first_td=losses[:20].mean().item(),
                  last_td=losses[-20:].mean().item())
    if on_card:
        ported = {}
        n = WM_PROFILED_STEPS
        dev_us, kernels = profile_loop(torch, lambda: loop(tstate, rb_state, n), n,
                                       wall / steps * 1e6, label, ported)
        result.update(device_us=dev_us, kernels_per_step=kernels, k3_us=ported["fused_mlp"],
                      k4_us=ported["nstep"], idle=1 - dev_us / (wall / steps * 1e6))

    def evaluate():
        reset_counts()
        t0 = time.perf_counter()
        returns = evaluate_policy(env, greedy_act, tstate, gen, num_episodes=eval_episodes).cpu()
        counts, plain = read_counts()
        if on_card and (counts["fused_mlp_forward"] != env.max_steps or plain):
            raise AssertionError(f"{label} eval: launches {counts}, plain {plain}")
        return returns.mean().item(), counts, time.perf_counter() - t0

    mean, eval_launches, eval_s = evaluate()
    extra = 0
    while extra < extensions and mean < cfg["bar"]:
        extra += 1
        tstate, rb_state, _ = loop(tstate, rb_state, cfg["extension_steps"])
        mean, eval_launches, eval_s = evaluate()
        log(f"  {label}: extension {extra} ({cfg['extension_steps']} steps), greedy mean "
            f"{mean:.3f}")
    log(f"  evaluate_policy: {eval_episodes} greedy episodes in {eval_s:.2f} s, mean "
        f"{mean:.4f} (the bar {cfg['bar']}: {'met' if mean >= cfg['bar'] else 'missed'}), K3 "
        f"launches {eval_launches['fused_mlp_forward']}"
        f"{', on ' + card_line() if on_card else ''}")
    result.update(eval_launches=eval_launches, mean_reward=mean, bar=cfg["bar"],
                  extensions=extra, eval_episodes=eval_episodes)
    return result


def world_model_phase(torch, wm_steps, prefill, steps, eval_episodes, extensions=0, device=None):
    """The world-model string pipeline: 512 random StringGame episodes of 6
    on the device, ``wm_steps`` MDN-RNN steps on them (the loss must fall),
    ``StateEmbedEnv`` over the trained weights (each step re-embeds its
    history through the LSTM), then the online DQN job on the embedded
    observations (``online_dqn_job``)."""
    from reagent_tpu_torch.gym.envs import StateEmbedEnv, StringGame

    dev = device or DEVICE
    cfg = WORLD_MODEL
    sync = torch.cuda.synchronize if dev != "cpu" else (lambda: None)
    env = StringGame(device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    batch = string_episodes(torch, env, cfg["episodes"], cfg["T"], gen)
    wm = mdnrnn_trainer(torch, cfg, dev)
    wm_state = wm.init(torch.Generator().manual_seed(1))
    reset_counts()
    losses = []
    for _ in range(wm_steps):
        wm_state, m = wm.train_step(wm_state, batch)
        losses.append(m["loss"])
    losses = torch.stack(losses).cpu()
    sync()
    wm_s = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    if not bool(losses[-1] < losses[0]) or any(launches.values()) or plain_calls:
        raise AssertionError(f"MDN-RNN: loss {losses[0].item()} -> {losses[-1].item()}, "
                             f"launches {launches}, plain calls {plain_calls}")
    log(f"  MDN-RNN on {cfg['episodes']} StringGame episodes of {cfg['T']}: {wm_steps} steps in "
        f"{wm_s:.2f} s ({wm_steps / wm_s:.1f} steps/s, the episodes' collection included), "
        f"loss {losses[0].item():.4f} -> {losses[-1].item():.4f}")
    embed_env = StateEmbedEnv(env, wm.memory_network, wm_state.params,
                              max_embed_seq_len=cfg["T"])
    trainer, q_values = wm_dqn_trainer(torch, cfg, embed_env.observation_dim, 2, dev)
    result = online_dqn_job(torch, "world-model DQN", embed_env, trainer, q_values, cfg, steps,
                            prefill, eval_episodes, dev, extensions)
    result.update(wm_steps=wm_steps, wm_loss=(losses[0].item(), losses[-1].item()), wm_s=wm_s)
    return result


def gridworld_phase(torch, prefill, steps, eval_episodes, device=None):
    from reagent_tpu_torch.gym.envs import OpenGridworld

    dev = device or DEVICE
    env = OpenGridworld(device=dev)
    trainer, q_values = wm_dqn_trainer(torch, GRIDWORLD_JOB, env.observation_dim,
                                       env.action_dim, dev)
    return online_dqn_job(torch, "OpenGridworld DQN", env, trainer, q_values, GRIDWORLD_JOB,
                          steps, prefill, eval_episodes, dev)


def mask_phase(torch, steps, eval_episodes, device=None):
    """The possible-actions-mask DQN as the JAX test runs it: each step an
    action uniform over the legal ones (the mask in the observation's tail,
    a gumbel-max over 0 / -1e9), the env step, the insert, an auto-reset
    (a device select here, a host branch there) and, after the first
    ``train_after`` + 1 steps, one sample of 128 (K4) with masked double-Q
    targets and one update; then a profiled window of 10 steps on the card
    and evaluate_policy over ``eval_episodes`` greedy masked episodes (K3
    once a step)."""
    import dataclasses

    from reagent_tpu_torch.gym.envs import PossibleActionsMaskTester, where_state
    from reagent_tpu_torch.gym.online_loop import evaluate_policy
    from reagent_tpu_torch.gym.policies.samplers import gumbel
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.replay import ReplayBuffer

    dev = device or DEVICE
    on_card = dev != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = MASK_JOB
    env = PossibleActionsMaskTester(device=dev)
    A, S = env.action_num, env.observation_dim
    trainer, q_values = wm_dqn_trainer(torch, cfg, S, A, dev)
    tstate = trainer.init(torch.Generator().manual_seed(0))
    rb = ReplayBuffer(replay_capacity=cfg["capacity"], update_horizon=1, gamma=cfg["gamma"],
                      device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    box = dict(rbs=rb.init(observation=torch.zeros(S), action=torch.tensor(0, dtype=torch.int32),
                           reward=torch.tensor(0.0), terminal=torch.tensor(False)),
               ts=tstate, env=env.reset(gen), i=0)

    def masked_batch(d):
        b = make_discrete_dqn_batch(d, A)
        return dataclasses.replace(
            b, possible_actions_mask=env.possible_actions_mask(b.state.float_features),
            possible_next_actions_mask=env.possible_actions_mask(b.next_state.float_features))

    def run(n):
        for _ in range(n):
            state, obs = box["env"]
            legal = torch.where(env.possible_actions_mask(obs) > 0, 0.0, -1e9)
            a = torch.argmax(legal + gumbel((A,), gen, dev)).to(torch.int32)
            nstate, nobs, rew, done = env.step(state, a, gen)
            box["rbs"] = rb.add(box["rbs"], observation=obs, action=a, reward=rew, terminal=done)
            rstate, robs = env.reset(gen)
            box["env"] = (where_state(done, rstate, nstate), torch.where(done, robs, nobs))
            if box["i"] > cfg["train_after"]:
                box["ts"], _ = trainer.train_step(
                    box["ts"], masked_batch(rb.sample(box["rbs"], gen, cfg["B"])))
            box["i"] += 1

    reset_counts()
    sync()
    t0 = time.perf_counter()
    run(steps)
    sync()
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    updates = steps - cfg["train_after"] - 1
    log(f"  mask DQN: {steps} env steps and {updates} updates in {wall:.3f} s = "
        f"{steps / wall:.2f} env steps/s, launches {launches}, plain calls {plain_calls}")
    others = {k: v for k, v in launches.items() if k != "nstep_rewards"}
    if on_card and (launches["nstep_rewards"] != updates or any(others.values()) or plain_calls):
        raise AssertionError(f"mask DQN: launches {launches} for {updates} updates, plain calls "
                             f"{plain_calls}")
    result = dict(launches=launches, steps=steps, updates=updates, steps_per_s=steps / wall)
    if on_card:
        ported = {}
        n = WM_PROFILED_STEPS
        step_us = wall / steps * 1e6
        dev_us, kernels = profile_loop(torch, lambda: run(n), n, step_us, "mask DQN", ported)
        result.update(device_us=dev_us, kernels_per_step=kernels, k4_us=ported["nstep"],
                      k3_us=ported["fused_mlp"], idle=1 - dev_us / step_us)

    def greedy_act(ts, obs, g):  # the scorer masks the illegal actions to -1e9
        return torch.argmax(q_values(ts, obs, env.possible_actions_mask(obs)), dim=1)

    reset_counts()
    t0 = time.perf_counter()
    returns = evaluate_policy(env, greedy_act, box["ts"], gen, num_episodes=eval_episodes).cpu()
    eval_launches, plain = read_counts()
    mean = returns.mean().item()
    if on_card and (eval_launches["fused_mlp_forward"] != env.max_steps or plain):
        raise AssertionError(f"mask DQN eval: launches {eval_launches}, plain {plain}")
    log(f"  evaluate_policy: {eval_episodes} greedy masked episodes in "
        f"{time.perf_counter() - t0:.2f} s, mean {mean:.2f} (the bar {cfg['bar']}: "
        f"{'met' if mean >= cfg['bar'] else 'missed'}), K3 launches "
        f"{eval_launches['fused_mlp_forward']}{', on ' + card_line() if on_card else ''}")
    result.update(eval_launches=eval_launches, mean_reward=mean, bar=cfg["bar"],
                  eval_episodes=eval_episodes)
    return result


def world_model_card_cpu_phase(torch, n=5):
    """The new modules on the card against the CPU: OpenGridworld and
    PossibleActionsMaskTester rollouts from the same actions and draws
    (observations and flags exactly, rewards atol 1e-6); ``n`` MDN-RNN train steps
    from one state on the same StringGame batch (losses rtol 1e-4, every
    parameter and Adam moment rtol 5e-4, atol 5e-5: section D of the tests'
    tolerances); then StateEmbedEnv over the trained weights, 8 episodes of 6
    steps as one batch, observations atol 1e-5.  No K1-K5 launch."""
    from reagent_tpu_torch.gym.envs import (
        OpenGridworld,
        PossibleActionsMaskTester,
        StateEmbedEnv,
        StringGame,
    )

    rng = np.random.default_rng(41)
    reset_counts()
    for make in (OpenGridworld, PossibleActionsMaskTester):
        envs = {d: make(device=d) for d in ("cpu", DEVICE)}
        gen = torch.Generator().manual_seed(42)
        draw = getattr(envs["cpu"], "reset_noise", None)
        noise = None if draw is None else draw(gen, 8)
        pairs = {d: e.reset(batch_size=8, **({} if noise is None else
                                              {"noise": noise.to(d)})) for d, e in envs.items()}
        for _ in range(40):
            a = torch.tensor(rng.integers(0, envs["cpu"].action_dim, 8), dtype=torch.int32)
            draw = getattr(envs["cpu"], "step_noise", None)
            noise = None if draw is None else draw(gen, (8,))
            out = {}
            for d, e in envs.items():
                kw = {} if noise is None else {"noise": noise.to(d)}
                st, ob, rw, dn = e.step(pairs[d][0], a.to(d), **kw)
                pairs[d] = (st, ob)
                out[d] = (ob.cpu(), rw.cpu(), dn.cpu())
            for got, want in zip(out[DEVICE], out["cpu"]):
                # the gridworld's reward 1 - 0.9 t / 100 may round another way
                torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        log(f"  {make.__name__}: 8 envs x 40 steps, card and CPU equal (rewards to 1e-6)")
    cfg = WORLD_MODEL
    trainers = {d: mdnrnn_trainer(torch, cfg, d, lr=0.01) for d in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(43))
    states = {d: copy_state(first, d) for d in trainers}
    batch = string_episodes(torch, StringGame(device="cpu"), 256, cfg["T"],
                            torch.Generator().manual_seed(44))
    worst_l = 0.0
    for _ in range(n):
        losses = {}
        for d, tr in trainers.items():
            states[d], m = tr.train_step(states[d], batch.to(d))
            losses[d] = {k: v.cpu() for k, v in m.items()}
        for k, want in losses["cpu"].items():
            torch.testing.assert_close(losses[DEVICE][k], want, **MDN_TOL["loss"], msg=k)
            worst_l = max(worst_l, (losses[DEVICE][k] - want).abs().item())
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], MDN_TOL["param"],
                                    "MDN-RNN")
    log(f"  MDN-RNN, card vs CPU, {n} train steps on [6, 256]: losses max abs {worst_l:.3e}; "
        f"{count} state tensors max abs {worst_p:.3e}")
    embeds = {d: StateEmbedEnv(StringGame(device=d), trainers[d].memory_network,
                               states[d].params, max_embed_seq_len=cfg["T"]) for d in trainers}
    pairs = {d: e.reset(batch_size=8) for d, e in embeds.items()}
    worst_o = 0.0
    for t in range(cfg["T"]):
        a = torch.tensor(rng.integers(0, 2, 8), dtype=torch.int32)
        obs = {}
        for d, e in embeds.items():
            st, ob, _, _ = e.step(pairs[d][0], a.to(d))
            pairs[d] = (st, ob)
            obs[d] = ob.cpu()
        torch.testing.assert_close(obs[DEVICE], obs["cpu"], rtol=0, atol=1e-5, msg=f"step {t}")
        worst_o = max(worst_o, (obs[DEVICE] - obs["cpu"]).abs().max().item())
    launches, plain_calls = read_counts()
    if any(launches.values()):
        raise AssertionError(f"world-model card vs CPU: launches {launches}")
    log(f"  StateEmbedEnv, card vs CPU, 8 episodes of {cfg['T']}: observations max abs "
        f"{worst_o:.3e}; K1-K5 launches 0")
    return dict(loss_err=worst_l, param_err=worst_p, obs_err=worst_o)


# --------------------------------------------------------------- sparse slice

# The sparse changing-arms DQN: tests/test_sparse_models.py:157-251 (reference
# gym/tests/configs/sparse/discrete_dqn_changing_arms_online.yaml, bar 400):
# ChangingArms(5 arms, 200 steps), the obs as dense [mus, changes] and the
# ID list of the legal arms, SparseDQN (("legal", 6, 8),) with a [64]
# leaky_relu overarch, gamma 0.5, tau 0.2, double-Q, Adam 0.003, a
# ReplayBuffer of 50,000, minibatch 256, masked-random prefill, masked
# softmax acting at temperature 2, greedy masked evaluation.  Phase 46 cuts
# the depth (prefill, steps, episodes); tools/sparse_jobs.py runs full_*
SPARSE_ARMS_JOB = dict(num_arms=5, max_steps=200, embedding_dim=8, widths=[64],
                       act="leaky_relu", gamma=0.5, tau=0.2, lr=0.003, capacity=50_000, B=256,
                       temperature=2.0, prefill=500, steps=600, eval_episodes=5,
                       full_prefill=2000, full_steps=15_000, full_eval_episodes=10, bar=400.0)
# bench.py's eighth workload (bench.py:38-41, :771-818): a 10M x 64 table,
# 4,096 x 50 ids a batch, head 256, 50 steps on one batch; phase 44 checks
# the step card against CPU at a table of 100,000
SPARSE_EMBEDDING = dict(table=10_000_000, dim=64, B=4096, L=50, head=256, steps=50,
                        profiled=5, check_table=100_000, check_B=512, check_L=50, check_steps=5)
# the card against the CPU: the head's products sum in another order, and the
# card's index_add_ adds a duplicate id's occurrences in an order that is not
# fixed (atomics); Adagrad scales each row's step to about lr, so an ulp of a
# gradient moves a row by an ulp of lr
SPARSE_STEP_TOL = dict(loss=dict(rtol=1e-5, atol=1e-7), table=dict(rtol=1e-5, atol=1e-6),
                       accum=dict(rtol=1e-4, atol=1e-9), head=dict(rtol=5e-4, atol=5e-5))
ARMS_TOL = dict(q=dict(rtol=1e-5, atol=1e-5), loss=dict(rtol=1e-4, atol=1e-6),
                param=dict(rtol=5e-4, atol=5e-5))
# K3's overarch at the act step and the greedy evaluation, K4's samples
K3_SPARSE_SHAPES = {
    "changing-arms act [1, 18->64->6]": (1, [18, 64, 6], ["leaky_relu", "linear"], True, 96),
    "changing-arms eval [10, 18->64->6]": (10, [18, 64, 6], ["leaky_relu", "linear"], True, 97),
}
K4_SPARSE_SHAPES = {"changing-arms loop": (50_000, 256, 1)}  # capacity, B, H
SPARSE_PROFILED_STEPS = 10


def sparse_arms_trainer(torch, device):
    """The job's DQNTrainer on ``ArmsSparseQNet`` and its scorer ``(state,
    obs [B, 15]) -> Q``: the bag concat in torch and the overarch one K3
    launch on the card (``training/functional.py::score``)."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.gym.sparse_arms import ArmsSparseQNet
    from reagent_tpu_torch.training import DQNTrainer, functional

    cfg = SPARSE_ARMS_JOB
    net = ArmsSparseQNet(num_arms=cfg["num_arms"], embedding_dim=cfg["embedding_dim"],
                         overarch_dims=cfg["widths"], activation=cfg["act"])
    trainer = DQNTrainer(
        q_network=net, rl=RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"],
                                       maxq_learning=True),
        optimizer={"Adam": {"lr": cfg["lr"]}}, double_q_learning=True, device=device)
    return trainer, lambda ts, obs: functional.score(trainer.q_network, ts.q_params, obs)


def sparse_arms_acting(torch, q_values, device):
    """(the act step, the greedy act, the masked-random prefill act, the
    batch maker) of the job, as the JAX test writes them: softmax over
    ``q / 2`` with the illegal arms at -1e9 (a gumbel-max on the loop's
    generator), argmax over the masked Q, a uniform draw over the legal
    actions, and the replay batch with both possible-actions masks."""
    import dataclasses

    from reagent_tpu_torch.gym.policies.samplers import gumbel
    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.gym.sparse_arms import legal_actions_mask

    K = SPARSE_ARMS_JOB["num_arms"]
    A, T = K + 1, SPARSE_ARMS_JOB["temperature"]

    def policy_act(ts, obs, g):
        logits = torch.where(legal_actions_mask(obs, K) > 0, q_values(ts, obs[None])[0] / T, -1e9)
        a = torch.argmax(logits + gumbel((A,), g, device)).to(torch.int32)
        return a, a

    def greedy_act(ts, obs, g):
        q = q_values(ts, obs)
        return torch.argmax(torch.where(legal_actions_mask(obs, K) > 0, q, -1e9), dim=1)

    def prefill_act(ts, obs, g):
        logits = torch.where(legal_actions_mask(obs, K) > 0, 0.0, -1e9)
        a = torch.argmax(logits + gumbel((A,), g, device)).to(torch.int32)
        return a, a

    def batch_maker(d):
        b = make_discrete_dqn_batch(d, A)
        return dataclasses.replace(
            b, possible_actions_mask=legal_actions_mask(b.state.float_features, K),
            possible_next_actions_mask=legal_actions_mask(b.next_state.float_features, K))

    return (policy_act, greedy_act), prefill_act, batch_maker


def sparse_arms_phase(torch, prefill, steps, eval_episodes, device=None):
    """The sparse changing-arms DQN through the generic loop
    (``online_dqn_job``): the masked-random prefill, ``steps`` steps of
    masked softmax acting (K3 once a step) and updates (K4 once a sample),
    a profiled window on the card, greedy masked evaluation (K3 once a
    step)."""
    from reagent_tpu_torch.gym.envs import ChangingArms

    dev = device or DEVICE
    cfg = SPARSE_ARMS_JOB
    env = ChangingArms(num_arms=cfg["num_arms"], max_steps=cfg["max_steps"], device=dev)
    trainer, q_values = sparse_arms_trainer(torch, dev)
    policies, prefill_act, batch_maker = sparse_arms_acting(torch, q_values, dev)
    return online_dqn_job(torch, "sparse changing-arms DQN", env, trainer, q_values, cfg, steps,
                          prefill, eval_episodes, dev, policies=policies,
                          batch_maker=batch_maker, prefill_act=prefill_act)


def arms_obs(rng, n):
    """``n`` ChangingArms observations [mus, legal, changes] (the first with
    only the pass legal)."""
    K = SPARSE_ARMS_JOB["num_arms"]
    legal = (rng.random((n, K)) > 0.5).astype(np.float64)
    legal[0] = 0.0
    return np.concatenate([rng.uniform(-10, 10, (n, K)), legal, rng.normal(size=(n, K))],
                          axis=1).astype(np.float32)


def sparse_embedding_inputs(torch, rng, table, B, L, device):
    """ids [B, L] over the table (a hot id in every row and repeats inside
    every third row), a padded mask (lengths 1..L) and targets."""
    ids = rng.integers(0, table, (B, L))
    ids[:, 0] = 7
    ids[::3, 1] = ids[::3, 2]
    lengths = rng.integers(1, L + 1, B)
    mask = np.arange(L)[None, :] < lengths[:, None]
    target = rng.normal(size=(B, 1)).astype(np.float32)
    return (torch.tensor(ids, device=device), torch.tensor(mask, device=device),
            torch.tensor(target, device=device))


def arms_raw(rng):
    """One changing-arms transition batch of SPARSE_ARMS_JOB["B"] rows, numpy."""
    K, B = SPARSE_ARMS_JOB["num_arms"], SPARSE_ARMS_JOB["B"]
    return dict(state=arms_obs(rng, B), next_state=arms_obs(rng, B),
                action=rng.integers(0, K + 1, B).astype(np.int32),
                next_action=rng.integers(0, K + 1, B).astype(np.int32),
                reward=(rng.normal(size=B) * 3).astype(np.float32),
                terminal=rng.random(B) < 0.1, step=np.ones(B, np.int32))


def arms_batch(torch, raw, device):
    """``arms_raw``'s rows as the job's DQN batch on ``device``, its masks
    the legal arms (and the pass)."""
    import dataclasses

    from reagent_tpu_torch.gym.preprocessors import make_discrete_dqn_batch
    from reagent_tpu_torch.gym.sparse_arms import legal_actions_mask

    K = SPARSE_ARMS_JOB["num_arms"]
    b = make_discrete_dqn_batch({k: torch.tensor(v, device=device) for k, v in raw.items()},
                                K + 1)
    return dataclasses.replace(
        b, possible_actions_mask=legal_actions_mask(b.state.float_features, K),
        possible_next_actions_mask=legal_actions_mask(b.next_state.float_features, K))


def sparse_card_cpu_phase(torch, n=5):
    """Phase 44: the changing-arms net's forward and ``n`` DQNTrainer steps,
    then ``n`` touched-rows sparse embedding steps, each card against CPU
    from one state.  No K1-K5 launch (the trainer's forward is the
    module's; K3 serves only the act step)."""
    from reagent_tpu_torch.ops import sparse_embedding as se
    from reagent_tpu_torch.training import functional

    rng = np.random.default_rng(61)
    reset_counts()
    trainers = {d: sparse_arms_trainer(torch, d)[0] for d in ("cpu", DEVICE)}
    first = trainers["cpu"].init(torch.Generator().manual_seed(62))
    states = {d: copy_state(first, d) for d in trainers}
    obs = torch.tensor(arms_obs(rng, 256))
    q = {d: functional.apply(t.q_network, states[d].q_params, obs.to(d)).detach().cpu()
         for d, t in trainers.items()}
    torch.testing.assert_close(q[DEVICE], q["cpu"], **ARMS_TOL["q"])
    q_err = (q[DEVICE] - q["cpu"]).abs().max().item()
    worst_l = 0.0
    for _ in range(n):
        raw = arms_raw(rng)
        losses = {}
        for d, tr in trainers.items():
            states[d], m = tr.train_step(states[d], arms_batch(torch, raw, d))
            losses[d] = {k: v.cpu() for k, v in m.items()}
        for k, want in losses["cpu"].items():
            torch.testing.assert_close(losses[DEVICE][k], want, **ARMS_TOL["loss"], msg=k)
            worst_l = max(worst_l, (losses[DEVICE][k] - want).abs().item())
    count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], ARMS_TOL["param"],
                                    "changing-arms DQN")
    log(f"  changing-arms SparseDQN, card vs CPU: Q on [256, 15] max abs {q_err:.3e}; {n} "
        f"DQNTrainer steps (B {SPARSE_ARMS_JOB['B']}): metrics max abs {worst_l:.3e}, {count} "
        f"state tensors max abs {worst_p:.3e}")

    cfg, tol = SPARSE_EMBEDDING, SPARSE_STEP_TOL
    T, D = cfg["check_table"], cfg["dim"]
    init, head_apply, opt = se.init_sparse_embedding_state(
        torch.Generator().manual_seed(63), T, D, head_hidden=cfg["head"], device="cpu")
    sstates = {d: copy_state(init, d) for d in ("cpu", DEVICE)}
    step = se.make_sparse_embedding_train_step(head_apply, opt)
    errs = dict(loss=0.0, table=0.0, accum=0.0, head=0.0)
    dup = 0
    for i in range(n):
        ids, mask, target = sparse_embedding_inputs(torch, rng, T, cfg["check_B"], cfg["check_L"],
                                                    "cpu")
        valid = ids[mask]
        dup = max(dup, valid.numel() - valid.unique().numel())
        losses = {}
        for d in sstates:
            sstates[d], losses[d] = step(sstates[d], ids.to(d), mask.to(d), target.to(d))
        torch.testing.assert_close(losses[DEVICE].cpu(), losses["cpu"], **tol["loss"])
        errs["loss"] = max(errs["loss"], (losses[DEVICE].cpu() - losses["cpu"]).abs().item())
    got, want = sstates[DEVICE], sstates["cpu"]
    for key, g, w in (("table", got.table, want.table), ("accum", got.accum, want.accum),
                      *(("head", got.head_params[k], v) for k, v in want.head_params.items())):
        torch.testing.assert_close(g.cpu(), w, **tol[key], msg=key)
        errs[key] = max(errs[key], (g.cpu() - w).abs().max().item())
    launches, plain_calls = read_counts()
    if any(launches.values()):
        raise AssertionError(f"sparse card vs CPU: launches {launches}")
    log(f"  sparse embedding step, card vs CPU, {T} x {D}, B {cfg['check_B']}, L "
        f"{cfg['check_L']}, {n} steps ({dup} repeated ids among the valid ones of a batch, "
        f"padded slots in every batch): max abs loss {errs['loss']:.3e}, table "
        f"{errs['table']:.3e}, accumulator {errs['accum']:.3e}, head {errs['head']:.3e}; K1-K5 "
        f"launches 0")
    return dict(q_err=q_err, loss_err=worst_l, param_err=worst_p, embedding_errs=errs)


def sparse_embedding_scale_phase(torch, name):
    """Phase 45: the touched-rows step at bench.py's size on the card, 50
    steps on one batch (bench.py's protocol: uniform ids over the table, no
    padding, the same batch each step); the loss must fall.  Steps/s from
    CUDA-synchronised wall time, the table's effective GB/s (3 B L D 4 bytes
    a step: the gather and the scatter's read and write), a profiled window
    and the peak of ``torch.cuda.max_memory_allocated``."""
    from reagent_tpu_torch.ops import sparse_embedding as se

    cfg = SPARSE_EMBEDDING
    T, D, B, L = cfg["table"], cfg["dim"], cfg["B"], cfg["L"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, head_apply, opt = se.init_sparse_embedding_state(
        torch.Generator(device=DEVICE).manual_seed(0), T, D, head_hidden=cfg["head"],
        device=DEVICE)
    step = se.make_sparse_embedding_train_step(head_apply, opt)
    rng = np.random.default_rng(0)
    ids = torch.tensor(rng.integers(0, T, (B, L)), device=DEVICE)
    mask = torch.ones((B, L), dtype=torch.bool, device=DEVICE)
    target = torch.tensor(rng.normal(size=(B, 1)).astype(np.float32), device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state, first = step(state, ids, mask, target)  # warm
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for _ in range(cfg["steps"]):
        state, loss = step(state, ids, mask, target)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = torch.stack(losses).cpu()
    launches, plain_calls = read_counts()
    if not bool(losses[-1] < losses[0]) or any(launches.values()) or plain_calls:
        raise AssertionError(f"sparse embedding at scale: loss {losses[0].item()} -> "
                             f"{losses[-1].item()}, launches {launches}, plain {plain_calls}")
    peak = torch.cuda.max_memory_allocated()
    sps = cfg["steps"] / wall
    nbytes = 3.0 * B * L * D * 4
    box = {"state": state}

    def run(n):
        for _ in range(n):
            box["state"], _ = step(box["state"], ids, mask, target)

    n = cfg["profiled"]
    dev_us, kernels = profile_loop(torch, lambda: run(n), n, wall / cfg["steps"] * 1e6,
                                   "sparse embedding")
    b_ms, b_by = roofline(0.0, nbytes, name)
    log(f"  sparse embedding step, {T} x {D} table ({T * D * 4 / 1e9:.2f} GB) + accumulator "
        f"({T * 4 / 1e6:.0f} MB), B {B}, L {L}, head {cfg['head']}: set-up {init_s:.2f} s, "
        f"{cfg['steps']} steps in {wall:.4f} s = {sps:.2f} steps/s, the table's effective "
        f"{sps * nbytes / 1e9:.2f} GB/s (3 B L D 4 = {nbytes / 1e6:.1f} MB a step; at the memory "
        f"rate {b_ms:.4f} ms a step), {kernels:.1f} CUDA kernels and {dev_us:.1f} us of device "
        f"time a step (idle {(1 - dev_us / (wall / cfg['steps'] * 1e6)) * 100:.1f}%), loss "
        f"{first.item():.5f} -> {losses[-1].item():.5f}, peak memory {peak / 2**30:.3f} GiB, on "
        f"{card_line()}")
    del state, box
    torch.cuda.empty_cache()
    return dict(steps_per_s=sps, gb_per_s=sps * nbytes / 1e9, kernels_per_step=kernels,
                device_us=dev_us, idle=1 - dev_us / (wall / cfg["steps"] * 1e6),
                peak_bytes=peak, loss=(first.item(), losses[-1].item()), bytes_per_step=nbytes,
                memory_bound_ms=b_ms)

# ------------------------------------------------------------- ranking slice

# bench.py's Seq2Slate workloads (bench.py:499-507, :511-535, :611-650):
# _S2S (2 layers, 8 heads, dim 256, feed-forward 512, state and candidate
# dims 128, S = T = 20) trained at B 256 on the _s2s_batch_arrays batch
# (on_policy False, IPSClamp(UNIVERSAL, 10), Adam 1e-4), _S2S_LARGE (dim
# 1024, feed-forward 4096) in bfloat16 at B 1024, and greedy RANK_MODE at B
# 512.  Phase 47 holds the card against the CPU on 64 rows; phase 48 times
# 20, 5 and 10 of them (the bench's 40 steps, 20 ranks cut to fit the limit)
S2S = dict(state_dim=128, candidate_dim=128, num_stacked_layers=2, num_heads=8, dim_model=256,
           dim_feedforward=512, max_src_seq_len=20, max_tgt_seq_len=20)
S2S_LARGE = dict(S2S, dim_model=1024, dim_feedforward=4096)
S2S_RUN = dict(B=256, steps=20, large_B=1024, large_steps=5, rank_B=512, ranks=10, profiled=1,
               lr=1e-4, clamp=10.0, check_rows=64, check_steps=3)
# the card against the CPU: the per-sequence log-probabilities sum 20 logs
# of probabilities each an ulp or so apart; the IPS metrics 1e-4 relative
S2S_TOL = dict(log_prob=dict(rtol=1e-5, atol=1e-5), metrics=dict(rtol=1e-4, atol=0.0),
               decode_atol=1e-6)
# slate-Q on RecSim (tests/test_slateq_recsim.py:173-228, reference
# gym/tests/configs/recsim/slate_q_recsim_online.yaml, bar 154): phase 49
# runs the base variant cut to 1 round of 10 episodes at epsilon 1.0, 100
# updates and 5 greedy episodes; tools/ranking_jobs.py runs all five at
# full depth (4 rounds of 150 episodes, 600 updates each, 20 episodes)
SLATE_Q_CUT = dict(name="base", episodes=10, epsilons=(1.0,), train_steps=100, eval_episodes=5)
SLATE_Q_TOL = dict(q=dict(rtol=1e-5, atol=1e-6), loss=dict(rtol=1e-4, atol=1e-6),
                   param=dict(rtol=5e-4, atol=5e-5))
# K3 at the slate-Q act step: one state's 10 candidate rows through the
# critic [41 -> 64 -> 64 -> 1] leaky_relu (the resident route)
K3_RANKING_SHAPES = {
    "slate-Q act [10, 41->64->64->1]": (10, [41, 64, 64, 1],
                                        ["leaky_relu", "leaky_relu", "linear"], True, 111),
}


def s2s_batch_arrays(seed=0, cfg=S2S, batch_size=256):
    """bench.py's ``_s2s_batch_arrays`` (:518): normal state and candidates,
    the logged slate a random permutation of the first T candidates (+2),
    propensity 1e-3, uniform rewards."""
    g = np.random.default_rng(seed)
    B = batch_size
    S, T = cfg["max_src_seq_len"], cfg["max_tgt_seq_len"]
    SD, CD = cfg["state_dim"], cfg["candidate_dim"]
    state = g.normal(size=(B, SD)).astype(np.float32)
    src = g.normal(size=(B, S, CD)).astype(np.float32)
    tgt_out = np.stack([g.permutation(S)[:T] + 2 for _ in range(B)]).astype(np.int64)
    tgt_in = np.concatenate([np.ones((B, 1), np.int64), tgt_out[:, :-1]], axis=1)
    cand = np.concatenate([np.zeros((B, 2, CD), np.float32), src], axis=1)
    tgt_in_seq = np.take_along_axis(cand, tgt_in[:, :, None], axis=1)
    probs = np.full((B, 1), 1e-3, np.float32)
    reward = g.uniform(0.0, 1.0, size=(B, 1)).astype(np.float32)
    return state, src, tgt_in, tgt_out, tgt_in_seq, probs, reward


def s2s_batch(torch, device, cfg=S2S, batch_size=256, seed=0):
    from reagent_tpu_torch.core import types as rlt

    state, src, tgt_in, tgt_out, tgt_in_seq, probs, reward = (
        torch.tensor(x, device=device) for x in s2s_batch_arrays(seed, cfg, batch_size))
    return rlt.PreprocessedRankingInput(
        state=rlt.FeatureData(float_features=state), src_seq=rlt.FeatureData(float_features=src),
        tgt_in_seq=rlt.FeatureData(float_features=tgt_in_seq), tgt_in_idx=tgt_in,
        tgt_out_idx=tgt_out, tgt_out_probs=probs, slate_reward=reward)


def s2s_trainer(torch, device, cfg=S2S, compute_dtype=None):
    """bench.py's trainer: an AUTOREGRESSIVE model (parameters from the
    module's seed-0 init), off-policy IPS clamped at 10, Adam 1e-4."""
    from reagent_tpu_torch.core.parameters import IPSClamp, IPSClampMethod, Seq2SlateParameters
    from reagent_tpu_torch.models.seq2slate import Seq2SlateOutputArch, Seq2SlateTransformerModel
    from reagent_tpu_torch.training.ranking import Seq2SlateTrainer

    model = Seq2SlateTransformerModel(**cfg, output_arch=Seq2SlateOutputArch.AUTOREGRESSIVE,
                                      compute_dtype=compute_dtype or torch.float32)
    return Seq2SlateTrainer(
        model, params=Seq2SlateParameters(
            on_policy=False, ips_clamp=IPSClamp(IPSClampMethod.UNIVERSAL, S2S_RUN["clamp"])),
        policy_optimizer={"Adam": {"lr": S2S_RUN["lr"]}}, device=device)


def ranking_card_cpu_phase(torch):
    """Phase 47: Seq2Slate at _S2S width on 64 rows from one state dict, card
    against CPU: the greedy slates (identical), the logged slates'
    per-sequence log-probabilities, the card's cached decode against its
    full decode re-run on the decoded prefix (the same argmax, per-symbol
    probabilities within 1e-6), 3 IPS steps' metrics; then slate-Q's item
    scores through the scorer (one K3 launch on the card) and 3 trainer
    steps."""
    from reagent_tpu_torch.gym import slate_q_recsim as sq
    from reagent_tpu_torch.ops import fused_mlp

    n, rows = S2S_RUN["check_steps"], S2S_RUN["check_rows"]
    trainers = {d: s2s_trainer(torch, d) for d in ("cpu", DEVICE)}
    trainers[DEVICE].seq2slate_net.load_state_dict(trainers["cpu"].seq2slate_net.state_dict())
    batches = {d: s2s_batch(torch, d, batch_size=rows, seed=1) for d in trainers}
    out, logp = {}, {}
    for d, tr in trainers.items():
        b = batches[d]
        out[d] = tr.rank(tr.state_from_networks(), b, S2S["max_tgt_seq_len"], greedy=True)
        logp[d] = tr.seq2slate_net("per_sequence_log_prob", b.state.float_features,
                                   b.src_seq.float_features, tgt_in_idx=b.tgt_in_idx,
                                   tgt_out_idx=b.tgt_out_idx,
                                   tgt_in_seq=b.tgt_in_seq.float_features).per_seq_log_probs
    idx = out[DEVICE].ranked_tgt_out_idx
    if not torch.equal(idx.cpu(), out["cpu"].ranked_tgt_out_idx):
        raise AssertionError("Seq2Slate greedy slates differ, card against CPU")
    torch.testing.assert_close(logp[DEVICE].detach().cpu(), logp["cpu"].detach(),
                               **S2S_TOL["log_prob"])
    lp_err = (logp[DEVICE].detach().cpu() - logp["cpu"].detach()).abs().max().item()
    # the card's cached decode against its full decode on the decoded prefix
    net, b = trainers[DEVICE].seq2slate_net, batches[DEVICE]
    src, state = b.src_seq.float_features, b.state.float_features
    cand = torch.cat([torch.zeros((rows, 2, src.shape[2]), device=DEVICE), src], dim=1)
    tgt_in = torch.cat([torch.ones((rows, 1), dtype=torch.int64, device=DEVICE), idx[:, :-1]],
                       dim=1)
    with torch.no_grad():
        full = net.decode(net.encode(state, src), state, tgt_in,
                          torch.gather(cand, 1, tgt_in[:, :, None].expand(-1, -1, src.shape[2])))
    dec_err = (out[DEVICE].ranked_per_symbol_probs - full).abs().max().item()
    if dec_err > S2S_TOL["decode_atol"] or not torch.equal(full.argmax(dim=2), idx):
        raise AssertionError(f"cached decode against the full decode: max abs {dec_err:.3e}")
    states = {d: tr.state_from_networks() for d, tr in trainers.items()}
    worst = 0.0
    for i in range(n):
        m = {}
        for d, tr in trainers.items():
            states[d], m[d] = tr.train_step(states[d], s2s_batch(torch, d, batch_size=rows,
                                                                 seed=10 + i))
        for k, want in m["cpu"].items():
            got = m[DEVICE][k].cpu()
            torch.testing.assert_close(got, want, **S2S_TOL["metrics"], msg=f"step {i} {k}")
            worst = max(worst, ((got - want).abs() / want.abs().clamp(min=1e-30)).item())
    log(f"  Seq2Slate at _S2S width, {rows} rows, card vs CPU: greedy slates identical, "
        f"per-sequence log-probabilities max abs {lp_err:.3e} (of values near "
        f"{logp['cpu'].mean().item():.2f}), the cached decode against the full decode on the "
        f"card max abs {dec_err:.3e} with the same argmax, {n} IPS steps' metrics max relative "
        f"{worst:.3e}")

    tol = SLATE_Q_TOL
    qt = {d: sq.make_trainer("maxq_topk", True, {}, d) for d in ("cpu", DEVICE)}
    sfirst = qt["cpu"].init(torch.Generator().manual_seed(0))
    sstates = {d: copy_state(sfirst, d) for d in qt}
    env = sq.RecSimInterestEvolution(device="cpu")
    recs = sq.SlateQCollector(env, qt["cpu"].q_network).collect(
        sfirst.q_params, 1.0, 4, torch.Generator().manual_seed(1))
    batch = sq.batchify(env, recs)
    scores = {}
    st = batch.state
    rows64 = type(st)(float_features=st.float_features[:64], candidate_docs=type(
        st.candidate_docs)(float_features=st.candidate_docs.float_features[:64],
                           value=st.candidate_docs.value[:64]))
    for d, tr in qt.items():  # the CPU first: the counts read the card's call alone
        reset_counts()
        scores[d] = sq.SlateQCollector(sq.RecSimInterestEvolution(device=d), tr.q_network).score(
            sstates[d].q_params, rows64.to(d)).cpu()
    launches, _ = read_counts()
    if launches["fused_mlp_forward"] != 1:
        raise AssertionError(f"slate-Q scorer on the card: K3 launched {launches}")
    torch.testing.assert_close(scores[DEVICE], scores["cpu"], **tol["q"])
    q_err = (scores[DEVICE] - scores["cpu"]).abs().max().item()
    worst_l = 0.0
    for i in range(n):
        idx_rows = torch.arange(i * 64, i * 64 + 256) % batch.reward.shape[0]
        m = {}
        for d, tr in qt.items():
            sstates[d], m[d] = tr.train_step(sstates[d], sq.subsample(batch, idx_rows).to(d))
        for k in ("td_loss", "q_mean"):
            torch.testing.assert_close(m[DEVICE][k].cpu(), m["cpu"][k], **tol["loss"], msg=k)
            worst_l = max(worst_l, (m[DEVICE][k].cpu() - m["cpu"][k]).abs().item())
    count, worst_p = compare_states(torch, sstates[DEVICE], sstates["cpu"], tol["param"],
                                    "slate-Q")
    log(f"  slate-Q (max-Q top-k), card vs CPU: item scores on 64 RecSim states x 10 candidates "
        f"max abs {q_err:.3e} (one K3 launch on the card), {n} trainer steps (B 256) metrics max "
        f"abs {worst_l:.3e}, {count} state tensors max abs {worst_p:.3e}")
    return dict(log_prob_err=lp_err, decode_err=dec_err, metric_rel_err=worst, q_err=q_err)


def timed_steps(torch, run, n, label, profiled):
    """``run()`` ``n`` times (CUDA-synchronised wall time), then a profiled
    window of ``profiled`` calls: (wall ms a call, device us a call, CUDA
    kernels a call, host reads of device values a call, ``Memcpy DtoH``
    events a call).  A host read is an ``aten::_local_scalar_dense``
    (``.item()``, ``float()``); a ``Memcpy DtoH`` is a copy to the host
    that the device records (``.cpu()``).  Both make the host wait for the
    device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            run()
        torch.cuda.synchronize()
    device_us, _ = profiled_rows(prof, profiled)
    counts = {ev.key: ev.count for ev in prof.key_averages()}
    dev = sum(r[0] for r in device_us)
    kernels = sum(r[1] for r in device_us)
    reads = counts.get("aten::_local_scalar_dense", 0) / profiled
    copies = sum(c for k, c in counts.items() if k.startswith("Memcpy DtoH")) / profiled
    log(f"  {label}: {wall_ms:.3f} ms a call (wall, {n} calls), {dev:.1f} us of device kernels in "
        f"{kernels:.1f} launches a call (profiled window of {profiled}): the device is idle "
        f"{(1 - dev / (wall_ms * 1e3)) * 100:.1f}% of a call; host reads a call {reads:.1f}, "
        f"Memcpy DtoH a call {copies:.1f}")
    for us, count, key in device_us[:5]:
        log(f"    device {us:9.2f} us  x{count:<6.1f} {key[:80]}")
    return wall_ms, dev, kernels, reads, copies


def seq2slate_timed_phase(torch, name):
    """Phase 48: the IPS train step at _S2S, B 256, float32 (TF32 off) and at
    _S2S_LARGE, B 1024, bfloat16 activations; greedy RANK_MODE at _S2S, B 512
    (KV-cached, 20 decode steps): steps/s and slates/s from
    CUDA-synchronised wall time, CUDA kernels and device time a call (a
    profiled window), the idle share, the peak of
    ``torch.cuda.max_memory_allocated``.  The metrics must stay finite."""
    run = S2S_RUN
    out = {}
    for label, cfg, B, dtype, steps in (
            ("train _S2S f32 B 256", S2S, run["B"], torch.float32, run["steps"]),
            ("train _S2S_LARGE bf16 B 1024", S2S_LARGE, run["large_B"], torch.bfloat16,
             run["large_steps"])):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trainer = s2s_trainer(torch, DEVICE, cfg, dtype)
        batch = s2s_batch(torch, DEVICE, cfg, B)
        box = {"state": trainer.state_from_networks()}

        def step():
            box["state"], box["m"] = trainer.train_step(box["state"], batch)

        step()  # warm
        wall_ms, dev, kernels, reads, _ = timed_steps(torch, step, steps, label, run["profiled"])
        m = {k: v.item() for k, v in box["m"].items()}
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{label}: metrics {m}")
        peak = torch.cuda.max_memory_allocated()
        out[label] = dict(steps_per_s=1e3 / wall_ms, ms=wall_ms, device_us=dev,
                          kernels_per_step=kernels, idle=1 - dev / (wall_ms * 1e3),
                          host_reads=reads, peak_bytes=peak, metrics=m)
        log(f"  {label}: {1e3 / wall_ms:.2f} steps/s, peak memory {peak / 2**30:.3f} GiB, "
            f"obj_loss {m['obj_loss']:.4g}, on {card_line()}")
        del trainer, batch, box
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = s2s_trainer(torch, DEVICE)
    state = trainer.state_from_networks()
    batch = s2s_batch(torch, DEVICE, batch_size=run["rank_B"])
    T = S2S["max_tgt_seq_len"]

    def rank():
        return trainer.rank(state, batch, T, greedy=True).ranked_tgt_out_idx

    idx = rank()
    if not all(sorted(r) == list(range(2, T + 2)) for r in idx.cpu().tolist()):
        raise AssertionError("greedy ranks are not permutations of the candidates")
    label = "greedy rank _S2S B 512"
    wall_ms, dev, kernels, reads, _ = timed_steps(torch, rank, run["ranks"], label, run["profiled"])
    peak = torch.cuda.max_memory_allocated()
    out[label] = dict(slates_per_s=run["rank_B"] * 1e3 / wall_ms, ms=wall_ms, device_us=dev,
                      kernels_per_rank=kernels, kernels_per_decode_step=kernels / T,
                      idle=1 - dev / (wall_ms * 1e3), host_reads=reads, peak_bytes=peak)
    log(f"  {label}: {run['rank_B'] * 1e3 / wall_ms:.1f} slates/s, {kernels / T:.1f} CUDA kernels "
        f"a decode step, peak memory {peak / 2**30:.3f} GiB, on {card_line()}")
    return out


def slate_q_recsim_phase(torch, name, launch_floor_ms):
    """Phase 49: K3 at the slate-Q act shape against its plain version,
    timed; then slate-Q on RecSim cut in depth (SLATE_Q_CUT): every act
    step one K3 launch through ``slate_q_scorer`` (the counts read around
    the run), no plain call; env steps/s and a profiled episode (CUDA
    kernels and device time an env step, the idle share, host reads: one
    an env step, the episode's done flag)."""
    from reagent_tpu_torch.gym import slate_q_recsim as sq

    k3 = k3_shapes_phase(torch, name, K3_RANKING_SHAPES, K3_RANKING_SHAPES, launch_floor_ms)
    cut = SLATE_Q_CUT
    variant = next(v for v in sq.VARIANTS if v[0] == cut["name"])
    reset_counts()
    t0 = time.perf_counter()
    r = sq.train_and_eval(*variant, DEVICE, episodes=cut["episodes"], epsilons=cut["epsilons"],
                          train_steps=cut["train_steps"], eval_episodes=cut["eval_episodes"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    acts = r["train_act_steps"] + r["eval_act_steps"]
    others = {k: v for k, v in launches.items() if k != "fused_mlp_forward" and v}
    if launches["fused_mlp_forward"] != acts or plain or others:
        raise AssertionError(f"slate-Q on RecSim: {acts} act steps, launches {launches}, "
                             f"plain calls {plain}")
    env = sq.RecSimInterestEvolution(device=DEVICE)
    collector = sq.SlateQCollector(env, r["trainer"].q_network)
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    collector.collect(r["state"].q_params, 1.0, 1, gen)  # warm
    t0 = time.perf_counter()
    recs = collector.collect(r["state"].q_params, 1.0, 2, gen)
    torch.cuda.synchronize()
    n_steps = recs["reward"].shape[0]
    step_us = (time.perf_counter() - t0) / n_steps * 1e6
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        recs = collector.collect(r["state"].q_params, 1.0, 1, gen)
        torch.cuda.synchronize()
    n_prof = recs["reward"].shape[0]
    device_us, _ = profiled_rows(prof, n_prof)
    dev = sum(x[0] for x in device_us)
    kernels = sum(x[1] for x in device_us)
    k3_us = sum(us for us, _, key in device_us if "fused_mlp" in key)
    reads = {ev.key: ev.count for ev in prof.key_averages()}.get("aten::_local_scalar_dense", 0)
    log(f"  slate-Q on RecSim (base, 1 round of {cut['episodes']} episodes at epsilon 1.0, "
        f"{cut['train_steps']} updates at B 512, {cut['eval_episodes']} greedy episodes): "
        f"{wall:.2f} s, {r['transitions']} transitions, K3 launched {launches['fused_mlp_forward']} "
        f"times = the {acts} act steps, mean return {r['mean_return']:.2f} (the bar of "
        f"{r['bar']:.0f} is read at full depth), td_loss {r['first_td']:.4f} -> "
        f"{r['last_td']:.4f}")
    log(f"  slate-Q collection: {step_us:.1f} us an env step (wall), {dev:.1f} us of device "
        f"kernels in {kernels:.1f} launches an env step (profiled episode of {n_prof} steps), "
        f"K3 {k3_us:.2f} us of it: the device is idle {(1 - dev / step_us) * 100:.1f}% of a step; "
        f"host reads {reads / n_prof:.1f} a step (the done flag), on {card_line()}")
    return dict(k3=k3, launches=launches, acts=acts, train_act_steps=r["train_act_steps"],
                eval_act_steps=r["eval_act_steps"], mean_return=r["mean_return"], seconds=wall,
                steps_per_s=1e6 / step_us, device_us=dev, kernels_per_step=kernels,
                idle=1 - dev / step_us, k3_us=k3_us, host_reads_per_step=reads / n_prof)


# ---------------------------------------------------------- model-based slice

# The model-based jobs (reagent_tpu_torch/gym/model_based.py; the JAX tests'
# tests/test_world_models.py:225-404 and the Seq2RewardModel manager's
# widths): phase 52 cuts their depth and keeps every width;
# tools/model_based_jobs.py runs them at full depth (LinDyna 400 MDN-RNN
# steps a member and 5 episodes, CartPole 1,000 steps and 3 episodes of up to
# 200, Seq2Reward 1,000 and 500 steps and 10 greedy episodes)
MB_CUT = dict(lindyna_wm_steps=40, lindyna_episodes=1, cartpole_wm_steps=100,
              cartpole_episodes=1, cartpole_max_steps=40, s2r_steps=60, s2r_compress_steps=20,
              s2r_eval_episodes=5)
MB_TOL = dict(loss=dict(rtol=1e-4, atol=1e-6), param=dict(rtol=5e-4, atol=5e-5),
              fwd=dict(rtol=1e-4, atol=1e-5), cem=dict(rtol=1e-4, atol=1e-5))
MB_TIMED = dict(plans=10, s2r_steps=20, compress_steps=5, profiled=1)
# K3's serving forwards on this slice: the compress model's greedy act step
# over 10 CartPole episodes, the short-sequence planner's step model on 64
# states, the single-step synthetic reward of a 10-step window (S 4, A 2)
K3_MODEL_BASED_SHAPES = {
    "compress act [10, 4->64->64->2]": (10, [4, 64, 64, 2], ["relu", "relu", "linear"], True,
                                        121),
    "step model [64, 4->64->64->6]": (64, [4, 64, 64, 6], ["relu", "relu", "linear"], True, 122),
    "single-step reward [10, 6->64->32->1]": (10, [6, 64, 32, 1], ["relu", "relu", "linear"],
                                              True, 123),
}


def mb_close(torch, got, want, tol, what):
    """``got`` (any device) against ``want`` (CPU) within ``tol``; the max
    abs difference."""
    got = got.detach().cpu()
    torch.testing.assert_close(got, want.detach().cpu(), **tol,
                               msg=lambda m: f"{what}: card {got}, CPU {want}: {m}")
    return (got - want.detach()).abs().max().item() if got.numel() else 0.0


def cem_card_cpu(torch, worst):
    """CEM card against CPU at the jobs' widths, the draws made once on the
    CPU: the returns of 100 LinDyna solutions over 2 sampled members, of 100
    CartPole sequences in the expected mode, and each plan's choice where no
    first action (no elite boundary) is within 1e-4 of the next."""
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.gym import model_based as mb
    from reagent_tpu_torch.models.cem_planner import (
        CEMPlannerNetwork,
        RolloutDraws,
        truncated_normal,
    )
    from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
    from reagent_tpu_torch.training import functional

    def members(n, S, A, predict_delta=False):
        net = MemoryNetwork(S, A, 100, 2, 1, predict_delta)
        out = []
        for m in range(n):
            net.reset_parameters(torch.Generator().manual_seed(60 + m))
            out.append(functional.params_of(net))
        return net, out

    def draws_on(d, draws):
        return RolloutDraws(**{k: None if v is None else v.to(d)
                               for k, v in vars(draws).items()})

    lin = mb.LINDYNA_JOB
    net, params = members(2, 3, 2)
    kw = dict(cem_num_iterations=lin["iterations"], cem_population_size=lin["population"],
              ensemble_population_size=1, num_elites=lin["elites"],
              plan_horizon_length=lin["horizon"], state_dim=3, action_dim=2,
              discrete_action=False, terminal_effective=False, gamma=1.0,
              action_upper_bounds=np.ones(2), action_lower_bounds=-np.ones(2))
    planners = {d: CEMPlannerNetwork(net, params, device=d, **kw) for d in ("cpu", DEVICE)}
    gen = torch.Generator().manual_seed(61)
    P, H = lin["population"], lin["horizon"]
    init = torch.randn(3, generator=gen)
    sol = torch.rand((P, H, 2), generator=gen) * 2 - 1
    draws = planners["cpu"].draw_rollout(P, gen)
    acc = {d: p.acc_rewards_of_all_solutions(init.to(d), sol.to(d), draws_on(d, draws))
           for d, p in planners.items()}
    worst["cem"] = max(worst.get("cem", 0.0),
                       mb_close(torch, acc[DEVICE], acc["cpu"], MB_TOL["cem"], "LinDyna returns"))
    trunc = truncated_normal((lin["iterations"], P, H * 2), gen, "cpu").numpy()
    noise = [(trunc[i], planners["cpu"].draw_rollout(P, gen)) for i in range(lin["iterations"])]
    recorded = {d: [] for d in planners}
    plans = {}
    for d, p in planners.items():
        real = p.acc_rewards_of_all_solutions

        def rec(*a, _real=real, _d=d, **k):
            out = _real(*a, **k)
            recorded[_d].append(out.cpu().numpy())
            return out

        p.acc_rewards_of_all_solutions = rec
        plans[d] = p(rlt.FeatureData(init[None].to(d)),
                     noise=[(t, draws_on(d, dr)) for t, dr in noise]).cpu()
    tie = any(abs(np.sort(a)[-lin["elites"]] - np.sort(a)[-lin["elites"] - 1]) < 1e-4
              for a in recorded["cpu"])
    if not tie:
        worst["plan"] = mb_close(torch, plans[DEVICE], plans["cpu"],
                                 dict(rtol=1e-5, atol=1e-6), "LinDyna plan")
    log(f"  CEM on LinDyna (2 members, 100 hidden x 2, population {P}, horizon {H}): returns "
        f"card vs CPU max abs {worst['cem']:.3e}; the plan "
        f"{'held to 1e-5' if not tie else 'not compared (a near-tie at an elite boundary)'}")

    cp = mb.CARTPOLE_JOB
    net, (params,) = members(1, 4, 2, predict_delta=True)
    planners = {d: mb.cartpole_planner(net, params, d) for d in ("cpu", DEVICE)}
    P, H = cp["population"], cp["horizon"]
    obs = torch.randn((1, 4), generator=gen) * 0.05
    seqs = torch.randint(0, 2, (P, H), generator=gen)
    draws = planners["cpu"].draw_rollout(P, gen)
    onehot = torch.nn.functional.one_hot(seqs, 2).to(torch.float32)
    acc = {d: p.acc_rewards_of_all_solutions(obs[0].to(d), onehot.to(d), draws_on(d, draws))
           for d, p in planners.items()}
    worst["cem"] = max(worst["cem"], mb_close(torch, acc[DEVICE], acc["cpu"], MB_TOL["cem"],
                                              "CartPole returns"))
    a = acc["cpu"].numpy()
    means = np.sort([a[seqs[:, 0].numpy() == k].mean() for k in range(2)])
    best = {d: p(rlt.FeatureData(obs.to(d)), noise=(seqs.to(d), draws_on(d, draws)))[0]
            for d, p in planners.items()}
    tie = means[-1] - means[-2] <= 1e-4 * max(1.0, abs(means[-1]))
    if not tie and best[DEVICE] != best["cpu"]:
        raise AssertionError(f"CartPole plan: card {best[DEVICE]}, CPU {best['cpu']}")
    log(f"  CEM on CartPole (100 hidden x 2, predict_delta, population {P}, horizon {H}, the "
        f"expected mode): returns card vs CPU within {MB_TOL['cem']}, first action "
        f"{best[DEVICE]} on both{' (a near-tie: not compared)' if tie else ''}")


def model_based_card_cpu_phase(torch):
    """Phase 50: the model-based slice's modules at the jobs' widths, card
    against CPU: 3 Seq2Reward steps (64 hidden x 2, step classifier 64,
    multi_steps 6, B 256 CartPole windows) and 2 compress-model steps from
    one state (losses rtol 1e-4, every state tensor rtol 5e-4, atol 5e-5);
    CEM (``cem_card_cpu``); the six synthetic-reward nets at their builders'
    widths and 3 ``RewardNetTrainer`` steps; the serving wrappers (K3 once
    on the card for the compress model, the binary difference scorer, the
    short-sequence planner's step model and the single-step synthetic
    reward) and the evaluators."""
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.core.registry import SYNTHETIC_REWARD_NET_BUILDERS
    from reagent_tpu_torch.evaluation import world_model_evaluator as ev
    from reagent_tpu_torch.gym import model_based as mb
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.model_managers import Seq2RewardModel
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
    from reagent_tpu_torch.prediction import world_model_wrappers as pw
    from reagent_tpu_torch.prediction.synthetic_reward import SyntheticRewardPredictorWrapper
    from reagent_tpu_torch.training import functional
    from reagent_tpu_torch.training.reward_network_trainer import RewardNetTrainer
    from reagent_tpu_torch.training.world_model import CompressModelTrainer, MDNRNNTrainer

    devices = ("cpu", DEVICE)
    worst = {}
    corpus = mb.cartpole_corpus(CartPole(max_steps=200, device="cpu"), 64, 60,
                                torch.Generator().manual_seed(50))
    batches = [mb.cartpole_windows(corpus, 256, 6, torch.Generator().manual_seed(51 + i))
               for i in range(3)]
    manager = Seq2RewardModel(trainer_param={"multi_steps": 6, "action_names": ("l", "r")})
    trainers = {d: manager.build_trainer(None, state_dim=4, device=d) for d in devices}
    first = trainers["cpu"].init(torch.Generator().manual_seed(52))
    states = {d: copy_state(first, d) for d in devices}
    for b in batches:
        m = {}
        for d, tr in trainers.items():
            states[d], m[d] = tr.train_step(states[d], b.to(d))
        for k in m["cpu"]:
            worst["loss"] = max(worst.get("loss", 0.0), mb_close(torch, m[DEVICE][k], m["cpu"][k],
                                                                 MB_TOL["loss"], k))
    _, worst["param"] = compare_states(torch, states[DEVICE], states["cpu"], MB_TOL["param"],
                                       "Seq2Reward")
    compress = {d: CompressModelTrainer(FullyConnectedDQN(4, 2, [64, 64], ["relu", "relu"]),
                                        trainers[d].seq2reward_network, trainers[d].params,
                                        device=d) for d in devices}
    c0 = compress["cpu"].init(torch.Generator().manual_seed(53))
    cstates = {d: copy_state(c0, d) for d in devices}
    for b in batches[:2]:
        m = {}
        for d, tr in compress.items():
            cstates[d], m[d] = tr.train_step(cstates[d], b.to(d), states[d].params)
        worst["loss"] = max(worst["loss"], mb_close(torch, m[DEVICE]["mse_loss"],
                                                    m["cpu"]["mse_loss"], MB_TOL["loss"],
                                                    "compress mse"))
    _, w = compare_states(torch, cstates[DEVICE], cstates["cpu"], MB_TOL["param"], "compress")
    worst["param"] = max(worst["param"], w)
    log(f"  Seq2Reward (3 steps) and the compress model (2 steps, the planning Q over 64 "
        f"sequences of 6), card vs CPU: losses max abs {worst['loss']:.3e}, state tensors max "
        f"abs {worst['param']:.3e}")

    cem_card_cpu(torch, worst)

    gen = torch.Generator().manual_seed(54)
    T, B, S, A = 10, 64, 4, 2
    sparse_cfg = [["page", 1000, 16], ["item", 1000, 16]]
    ids = {name: rlt.IdListFeature(ids=torch.randint(0, 5000, (T, B, 5), generator=gen),
                                   mask=torch.rand((T, B, 5), generator=gen) > 0.3)
           for name, _, _ in sparse_cfg}
    sr_batch = rlt.MemoryNetworkInput(
        state=rlt.FeatureData(torch.randn((T, B, S), generator=gen), id_list_features=ids),
        action=rlt.FeatureData(torch.randn((T, B, A), generator=gen)), next_state=None,
        reward=torch.randn((T, B), generator=gen), not_terminal=None, time_diff=None, step=None,
        valid_step=torch.randint(1, T + 1, (B, 1), generator=gen))
    worst["synthetic"] = 0.0
    for builder in ({"SingleStepSyntheticReward": {}}, {"NGramSyntheticReward": {}},
                    {"NGramConvNetSyntheticReward": {}}, {"SequenceSyntheticReward": {}},
                    {"TransformerSyntheticReward": {}},
                    {"SparseArchSyntheticReward": {"embedding_configs": sparse_cfg}}):
        net = SYNTHETIC_REWARD_NET_BUILDERS.build(builder).build_synthetic_reward_network(
            None, None, state_dim=S, action_dim=A)
        net.reset_parameters(torch.Generator().manual_seed(55))
        params = functional.params_of(net)
        with torch.no_grad():
            out = {d: functional.apply(net.to(d), {k: v.to(d) for k, v in params.items()},
                                       sr_batch.to(d)) for d in devices}
        for f in ("predicted_reward", "output"):
            worst["synthetic"] = max(worst["synthetic"], mb_close(
                torch, getattr(out[DEVICE], f), getattr(out["cpu"], f), MB_TOL["fwd"],
                f"{next(iter(builder))} {f}"))
    reward_batch = rlt.MemoryNetworkInput(
        state=rlt.FeatureData(torch.randn((256, S), generator=gen)), action=None, next_state=None,
        reward=torch.randn(256, generator=gen), not_terminal=None, time_diff=None, step=None)
    rtrainers = {d: RewardNetTrainer(FullyConnectedDQN(S, 1, [64, 32], ["relu", "relu"]),
                                     optimizer={"Adam": {"lr": 0.01}}, device=d)
                 for d in devices}
    r0 = rtrainers["cpu"].init(torch.Generator().manual_seed(56))
    rstates = {d: copy_state(r0, d) for d in devices}
    for _ in range(3):
        m = {}
        for d, tr in rtrainers.items():
            rstates[d], m[d] = tr.train_step(rstates[d], reward_batch.to(d))
        worst["loss"] = max(worst["loss"], mb_close(torch, m[DEVICE]["loss"], m["cpu"]["loss"],
                                                    MB_TOL["loss"], "reward net loss"))
    compare_states(torch, rstates[DEVICE], rstates["cpu"], MB_TOL["param"], "reward net")
    log(f"  the six synthetic-reward nets at their builders' widths (T {T}, B {B}), card vs CPU: "
        f"max abs {worst['synthetic']:.3e}; 3 RewardNetTrainer steps within the lockstep "
        f"tolerances")

    values = torch.randn((64, S), generator=gen) * 0.1
    presence = torch.ones_like(values)
    s2r_net, s2r_params = {}, {}
    for d in devices:
        s2r_net[d] = trainers[d].seq2reward_network
        s2r_params[d] = states[d].params
    pres = {d: mb.identity_preprocessor(S, d) for d in devices}
    k3_calls = {"compress": 1, "binary difference": 1, "short-sequence step model": 1,
                "single-step synthetic reward": 1}
    binary = FullyConnectedDQN(S, 2, [64, 64], ["relu", "relu"])
    single = SYNTHETIC_REWARD_NET_BUILDERS.build(
        {"SingleStepSyntheticReward": {}}).build_synthetic_reward_network(
        None, None, state_dim=S, action_dim=A)
    single.reset_parameters(torch.Generator().manual_seed(57))
    sr_pre = {d: (mb.identity_preprocessor(S, d), mb.identity_preprocessor(A, d)) for d in devices}
    window = torch.randn((10, S + A), generator=gen)
    outs = {}
    for d in devices:
        reset_counts()
        w = {
            "compress": pw.CompressModelWithPreprocessor(
                compress[d].compress_model_network, cstates[d].params, pres[d])(
                values.to(d), presence.to(d)),
            "binary difference": pw.BinaryDifferenceScorerPredictorWrapper(
                pw.BinaryDifferenceScorerWithPreprocessor(binary.to(d), None, pres[d]))(
                values.to(d), presence.to(d)),
            "short-sequence step model": pw.Seq2RewardPlanShortSeqWithPreprocessor(
                s2r_net[d], s2r_params[d], trainers[d].step_predict_network,
                states[d].step_params, pres[d], 6, A)(values.to(d), presence.to(d)),
            "single-step synthetic reward": SyntheticRewardPredictorWrapper(
                10, *sr_pre[d], single.to(d), None)((window.to(d), torch.ones_like(window).to(d))),
            "planner": pw.Seq2RewardWithPreprocessor(s2r_net[d], s2r_params[d], pres[d], 6, A)(
                values.to(d), presence.to(d)),
        }
        launches, plain = read_counts()
        others = {k: v for k, v in launches.items() if k != "fused_mlp_forward" and v}
        if d != "cpu" and (launches["fused_mlp_forward"] != sum(k3_calls.values()) or others
                           or plain):
            raise AssertionError(f"the wrappers on the card: launches {launches}, plain {plain}")
        outs[d] = w
    worst["wrappers"] = max(mb_close(torch, outs[DEVICE][k], outs["cpu"][k], MB_TOL["fwd"], k)
                            for k in outs["cpu"])
    log(f"  the serving wrappers, card vs CPU: max abs {worst['wrappers']:.3e}; K3 launched "
        f"once each on the card for {', '.join(k3_calls)}")

    wm_net = MemoryNetwork(4, 2, 100, 2, 1)
    wm = {d: MDNRNNTrainer(wm_net, device=d) for d in devices}
    wm_params = functional.params_of(wm_net)
    wm_batch = batches[0]
    perm = torch.randperm(256, generator=gen)
    ev_out = {}
    for d in devices:
        p = {k: v.to(d) for k, v in wm_params.items()}
        b = wm_batch.to(d)
        ev_out[d] = (
            ev.LossEvaluator(wm[d], 4).evaluate(p, b)["loss"],
            ev.FeatureImportanceEvaluator(wm[d], True, 4, 2, [0, 1], [0, 1, 2, 3]).evaluate(
                p, b)["feature_loss_increase"],
            ev.FeatureSensitivityEvaluator(wm[d], 4, [0, 1, 2, 3]).evaluate(
                p, b, perm=perm)["feature_sensitivity"])
    for got, want in zip(ev_out[DEVICE], ev_out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    log(f"  the evaluators (losses, feature importance, sensitivity) on the CartPole windows, "
        f"card vs CPU within rtol 1e-4, atol 1e-5, on {card_line()}")
    return worst


def model_based_timed_phase(torch, name, launch_floor_ms):
    """Phase 51: K3 at this slice's serving shapes against its plain version,
    timed beside one torch.addmm a layer and the bound; the CEM plan at
    CartPole's population 100 and horizon 10 and at LinDyna's 10 iterations
    of population 100 (2 members): ms a plan (wall), CUDA kernels and device
    time a plan, the idle share, host reads; the Seq2Reward train step and
    the compress step at B 1,024: steps/s, kernels and the idle share."""
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.gym import model_based as mb
    from reagent_tpu_torch.gym.envs import CartPole
    from reagent_tpu_torch.model_managers import Seq2RewardModel
    from reagent_tpu_torch.models.cem_planner import CEMPlannerNetwork
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.models.mdn_rnn import MemoryNetwork
    from reagent_tpu_torch.training import functional
    from reagent_tpu_torch.training.world_model import CompressModelTrainer

    t0 = time.perf_counter()
    # ~0.1 s of GPU sleep outlasts the enqueue of 23 small launches
    k3 = k3_shapes_phase(torch, name, K3_MODEL_BASED_SHAPES, K3_MODEL_BASED_SHAPES,
                         launch_floor_ms, sleep_cycles=200_000_000)
    log(f"  [{time.perf_counter() - t0:.1f} s into the phase]")
    run = MB_TIMED
    out = {"k3": k3}
    gen = torch.Generator(device=DEVICE).manual_seed(70)
    net = MemoryNetwork(4, 2, 100, 2, 1, predict_delta=True)
    planner = mb.cartpole_planner(net, functional.params_of(net), DEVICE)
    obs = rlt.FeatureData(torch.zeros((1, 4), device=DEVICE))
    lin = mb.LINDYNA_JOB
    lnet = MemoryNetwork(3, 2, 100, 2, 1)
    lparams = []
    for m in range(2):
        lnet.reset_parameters(torch.Generator().manual_seed(71 + m))
        lparams.append(functional.params_of(lnet))
    lplanner = CEMPlannerNetwork(
        lnet, lparams, cem_num_iterations=lin["iterations"],
        cem_population_size=lin["population"], ensemble_population_size=1,
        num_elites=lin["elites"], plan_horizon_length=lin["horizon"], state_dim=3, action_dim=2,
        discrete_action=False, terminal_effective=False, gamma=1.0,
        action_upper_bounds=np.ones(2), action_lower_bounds=-np.ones(2), device=DEVICE)
    lobs = rlt.FeatureData(torch.ones((1, 3), device=DEVICE))
    for label, fn in (("CEM plan, CartPole (population 100, horizon 10, 1 member)",
                       lambda: planner(obs, gen)),
                      ("CEM plan, LinDyna (10 iterations, population 100, horizon 4, 2 members)",
                       lambda: lplanner(lobs, gen))):
        fn()  # warm
        wall_ms, dev, kernels, reads, _ = timed_steps(torch, fn, run["plans"], label,
                                                   run["profiled"])
        out[label] = dict(ms=wall_ms, device_us=dev, kernels=kernels,
                          idle=1 - dev / (wall_ms * 1e3), host_reads=reads)
        log(f"  [{time.perf_counter() - t0:.1f} s into the phase]")
    corpus = mb.cartpole_corpus(CartPole(max_steps=200, device=DEVICE), 1000, 200, gen)
    trainer = Seq2RewardModel(trainer_param={"multi_steps": 6, "action_names": ("l", "r")}
                              ).build_trainer(None, state_dim=4, device=DEVICE)
    box = {"s": trainer.init(torch.Generator().manual_seed(72))}
    batch = mb.cartpole_windows(corpus, 1024, 6, gen)
    compress = CompressModelTrainer(FullyConnectedDQN(4, 2, [64, 64], ["relu", "relu"]),
                                    trainer.seq2reward_network, trainer.params, device=DEVICE)
    box["c"] = compress.init(torch.Generator().manual_seed(73))

    def s2r_step():
        box["s"], box["m"] = trainer.train_step(box["s"], batch)

    def compress_step():
        box["c"], box["cm"] = compress.train_step(box["c"], batch, box["s"].params)

    for label, fn, n in (("Seq2Reward train step (B 1,024, 64 x 2, multi_steps 6)", s2r_step,
                          run["s2r_steps"]),
                         ("compress step (B 1,024, the planning Q over 64 sequences)",
                          compress_step, run["compress_steps"])):
        fn()  # warm
        wall_ms, dev, kernels, reads, _ = timed_steps(torch, fn, n, label, run["profiled"])
        out[label] = dict(steps_per_s=1e3 / wall_ms, ms=wall_ms, device_us=dev, kernels=kernels,
                          idle=1 - dev / (wall_ms * 1e3), host_reads=reads)
        log(f"  [{time.perf_counter() - t0:.1f} s into the phase]")
    log(f"  the CEM plans and Seq2Reward steps above on {card_line()}")
    out["corpus"] = corpus
    return out


def model_based_jobs_phase(torch, corpus):
    """Phase 52: the three CEM jobs and the Seq2Reward job cut in depth
    (MB_CUT; every width kept): no kernel launched by the CEM jobs (JAX's
    reach no pallas_call), K3 exactly once a greedy step of the compress
    model's evaluation and once for the short-sequence planner's step
    model, no plain-version call; the bars are read at full depth only."""
    from reagent_tpu_torch.gym import model_based as mb

    cut = MB_CUT
    out = {}
    for name, run in (
            ("CEM LinDyna, 1 world model", lambda: mb.cem_lindyna(
                1, DEVICE, cut["lindyna_wm_steps"], cut["lindyna_episodes"])),
            ("CEM LinDyna, 2 world models", lambda: mb.cem_lindyna(
                2, DEVICE, cut["lindyna_wm_steps"], cut["lindyna_episodes"])),
            ("CEM CartPole", lambda: mb.cem_cartpole(
                DEVICE, cut["cartpole_wm_steps"], cut["cartpole_episodes"],
                cut["cartpole_max_steps"], corpus=corpus)),
            ("Seq2Reward CartPole", lambda: mb.seq2reward_cartpole(
                DEVICE, cut["s2r_steps"], cut["s2r_compress_steps"], cut["s2r_eval_episodes"],
                corpus=corpus))):
        reset_counts()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = read_counts()
        want = 201 if name.startswith("Seq2Reward") else 0  # 200 greedy steps, the step model
        others = {k: v for k, v in launches.items() if k != "fused_mlp_forward" and v}
        if launches["fused_mlp_forward"] != want or others or plain:
            raise AssertionError(f"{name}: launches {launches}, plain calls {plain}")
        keep = {k: v for k, v in r.items() if isinstance(v, (int, float, list, tuple))}
        out[name] = dict(keep, seconds=seconds, launches=launches)
        if name.startswith("Seq2Reward"):
            log(f"  {name} ({r['steps']} and {r['compress_steps']} steps, {r['eval_episodes']} "
                f"greedy episodes): {seconds:.2f} s, {r['steps_per_s']:.1f} train steps/s, "
                f"mse {r['mse_loss'][0]:.4f} -> {r['mse_loss'][1]:.4f}, step entropy "
                f"{r['step_entropy_loss'][0]:.4f} -> {r['step_entropy_loss'][1]:.4f}, compress "
                f"mse {r['compress_mse'][0]:.4f} -> {r['compress_mse'][1]:.4f}, greedy return "
                f"of the compress model {r['compress_mean_return']:.2f} (K3 {want} launches), "
                f"of the planner {r['planner_mean_return']:.2f}")
        else:
            log(f"  {name} ({r['wm_steps']} MDN-RNN steps a member, {len(r['returns'])} "
                f"episodes): {seconds:.2f} s, {r['wm_steps_per_s']:.1f} MDN-RNN steps/s, losses "
                f"{r['wm_losses']}, {r['plan_ms']:.2f} ms a plan, mean return "
                f"{r['mean_return']:.3f} (the bar of {r['bar']} is read at full depth)")
    log(f"  on {card_line()}")
    return out


# -------------------------------------------------------------- bandits

# The bandit jobs (tools/cb_jobs.py at full depth): run_dynamic_bandit_env at
# DynamicBanditEnv's defaults (reagent_tpu/evaluation/cb/
# synthetic_contextual_bandit_data.py:30-37, the reference's sizes) for 300
# steps; the replay evaluation of the trained agent on 300 batches logged
# under a uniform policy; the JAX test's deep-represent job
# (tests/test_cb_evaluation.py:106-150); the JAX tests' bandits
# (tests/test_cb_mab.py:108-121) and compare_bandit_algos over all seven
# algorithms.  Phase 55 cuts their depth (CB_CUT) and keeps every width.
CB_DYNAMIC = dict(U=100, B=4, K=10, D=500, steps=300, seed=937162211)
CB_REPLAY = dict(log_batches=300, fresh_batches=100)
CB_DEEP = dict(D=6, K=4, B=32, sizes=[16, 4], lr=3e-3, steps=300, eval_rows=256)
CB_MAB = {"UCB1": ([0.2, 0.8, 0.5], 400, 0), "MetricUCB": ([0.1, 0.9], 300, 1),
          "UCBTuned": ([0.1, 0.9], 300, 1), "BernoulliBetaThompson": ([0.1, 0.9], 300, 1)}
CB_ALGOS = ("UCB1", "MetricUCB", "UCBTuned", "GreedyAlgo", "RandomActionsAlgo",
            "BernoulliBetaThompson", "NormalGammaThompson")
CB_TRIALS = 5
CB_CUT = dict(dynamic_steps=40, train_steps=40, log_batches=40, fresh_batches=10,
              deep_steps=60, mab_steps=60, trials=1)
# card against CPU (phase 53): the sums in each device's order; the
# pseudo-inverse (cuSOLVER's SVD against LAPACK's) scaled by its largest
# entry, and in the dynamic run's first steps, where the ridge directions
# are kept at a condition number up to 1 / (5000 eps), the coefficients
# (3.058e-03 at step 1 on an H100 80GB HBM3) and the inverse (ridge_inv),
# the inverse checked only where no singular value lies within
# ``cutoff_margin`` of JAX's cutoff (there the two SVDs may keep a different
# number of them; 3.175e-04 at most, 8.63e-06 from step 8 on, on an H100
# 80GB HBM3); the UCB scores; near-ties of the top two UCB scores.  A
# pseudo-inverse at torch's default cutoff, planted on the CPU's side of
# that run, must part from it by more than ridge_inv: it inverts the ridge
# directions JAX's cutoff zeroes, which the inverse sees whole (6.730e+03)
# and the coefficients hardly at all (1.671e-03, under the card's own
# 3.058e-03: their component of avg_b is rounding).  The
# deep-represent steps hold the gradient Adam consumes (recovered from its
# first moment) at ``grad`` of each leaf's largest entry; a parameter whose
# gradient is over ``conditioned`` of that largest entry within
# ``param_lr`` learning rates, the others (a gradient at rounding level,
# which Adam scales to a step of up to lr) within 2 (the gradients agreed to
# 1.889e-05, 4 entries stepped apart, on an H100 80GB HBM3).
CB_TOL = dict(sum=dict(rtol=1e-5, atol=1e-5), pinv=2e-3, ridge_coefs=1e-2, ridge_inv=1e-2,
              cutoff_margin=1e-2, ucb=dict(rtol=1e-3, atol=1e-3),
              loss=dict(rtol=1e-4, atol=1e-6), grad=1e-4, conditioned=1e-2, param_lr=1e-2,
              mab=dict(rtol=1e-6, atol=1e-6), near_tie=1e-3)
# K3 on the deep-represent score: the JAX test's greedy evaluation (256 rows
# of 4 arms) and one train batch's arms (32 x 4), trunk 6->16->4 relu
K3_CB_SHAPES = {
    "deep-represent score [1024, 6->16->4]": (1024, [6, 16, 4], ["relu", "relu"], True, 131),
    "deep-represent score [128, 6->16->4]": (128, [6, 16, 4], ["relu", "relu"], True, 132),
}


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dynamic_draws(torch, steps, device, cfg=CB_DYNAMIC):
    """DynamicBanditEnv's catalogue and ``steps`` batches' draws, made on the
    CPU from cfg's seed and moved to ``device``: the card and the CPU run
    on the same inputs."""
    gen = torch.Generator().manual_seed(cfg["seed"])
    U, B, K, D = cfg["U"], cfg["B"], cfg["K"], cfg["D"]
    catalogue = {"ids": torch.randperm(U * B * K, generator=gen),
                 "mf": torch.randn((U, B, K, D), generator=gen),
                 "sf": torch.randn((U, B, K, D), generator=gen),
                 "weight": torch.randn(D, generator=gen),
                 "shifts": torch.randn(U * B * K, generator=gen)}
    draws = [(torch.randint(0, U, (), generator=gen), torch.randn((B, K, D), generator=gen),
              torch.randn((B, K), generator=gen)) for _ in range(steps)]
    return ({k: v.to(device) for k, v in catalogue.items()},
            [tuple(x.to(device) for x in d) for d in draws])


def regret_halves(regrets):
    """The JAX test's per-step regret of each half (tests/test_cb_evaluation.py:93-103)."""
    regrets = np.asarray(regrets)
    half = len(regrets) // 2
    return regrets[half] / half, (regrets[-1] - regrets[half]) / half


def dynamic_linucb_job(torch, device, steps):
    """run_dynamic_bandit_env at DynamicBanditEnv's defaults for ``steps``
    steps on ``device``: per-step regret of each half, the bar (second
    under half the first), steps/s (wall, the draws made beforehand)."""
    from reagent_tpu_torch.evaluation.cb.synthetic_contextual_bandit_data import (
        run_dynamic_bandit_env,
    )

    cfg = CB_DYNAMIC
    catalogue, draws = dynamic_draws(torch, steps, device)
    sync(torch, device)
    t0 = time.perf_counter()
    _, rewards, regrets = run_dynamic_bandit_env(
        cfg["U"], cfg["B"], cfg["K"], cfg["D"], steps, cfg["seed"], device,
        catalogue=catalogue, batch_draws=draws)
    seconds = time.perf_counter() - t0  # the regrets were read back: synchronised
    first, second = regret_halves(regrets)
    return dict(steps=steps, seconds=seconds, steps_per_s=steps / seconds,
                regret_per_step_first_half=first, regret_per_step_second_half=second,
                bar_met=bool(second < 0.5 * first), final_regret=regrets[-1],
                final_reward=rewards[-1])


def replay_eval_job(torch, device, train_steps, log_batches, fresh_batches):
    """The dynamic env's LinUCB agent trained ``train_steps`` steps, then
    judged offline: ``log_batches`` batches logged under a uniform policy
    (log_prob = log(1/K)) through the PolicyEvaluator with the agent's
    greedy actions; and its on-policy mean reward on ``fresh_batches`` new
    batches.  No bar: the estimate should sit near the on-policy mean, and
    frac_accepted near 1/K."""
    from reagent_tpu_torch.evaluation.cb import PolicyEvaluator
    from reagent_tpu_torch.evaluation.cb.synthetic_contextual_bandit_data import (
        DynamicBanditAgent,
        DynamicBanditEnv,
    )

    cfg = CB_DYNAMIC
    B, K = cfg["B"], cfg["K"]
    catalogue, draws = dynamic_draws(torch, train_steps + log_batches + fresh_batches, device)
    logging = torch.randint(0, K, (log_batches, B), generator=torch.Generator().manual_seed(
        cfg["seed"] + 1)).to(device)
    env = DynamicBanditEnv(cfg["U"], B, K, cfg["D"], catalogue=catalogue, device=device)
    agent = DynamicBanditAgent.make_agent(feature_dim=cfg["D"], device=device)
    state = agent.init_state()
    t0 = time.perf_counter()
    for i in range(train_steps):
        obs, rewards_all = env.get_batch(draws[i])
        action, _ = agent.act(state, obs)
        state, _ = agent.learn(state, env.add_chosen_action_reward(action.reshape(-1), obs,
                                                                   rewards_all))
    pe = PolicyEvaluator()
    ev_state = pe.init_state(device)
    log_prob = torch.full((B, 1), float(np.log(1.0 / K)), device=device)
    for i in range(log_batches):
        obs, rewards_all = env.get_batch(draws[train_steps + i])
        logged = env.add_chosen_action_reward(logging[i], obs, rewards_all).replace(
            log_prob=log_prob)
        model_actions, _ = agent.act(state, obs)
        ev_state, _ = pe.ingest_batch(ev_state, logged, model_actions)
    ev_state = pe.aggregate_across_instances(ev_state)
    on_policy = []
    for i in range(fresh_batches):
        obs, rewards_all = env.get_batch(draws[train_steps + log_batches + i])
        action, _ = agent.act(state, obs)
        on_policy.append(rewards_all[torch.arange(B, device=device), action.reshape(-1)])
    on_policy_mean = float(torch.cat(on_policy).mean())
    return dict(train_steps=train_steps, log_batches=log_batches, fresh_batches=fresh_batches,
                seconds=time.perf_counter() - t0, estimate=pe.get_avg_reward(ev_state),
                frac_accepted=float(ev_state.frac_accepted),
                logging_policy_mean_reward=float(ev_state.avg_reward_all_data),
                on_policy_mean_reward=on_policy_mean,
                result=pe.get_formatted_result_string(ev_state))


def deep_represent_trainer(torch, device):
    from reagent_tpu_torch.models.deep_represent_linucb import DeepRepresentLinearRegressionUCB
    from reagent_tpu_torch.training.cb import DeepRepresentLinUCBTrainer

    c = CB_DEEP
    return DeepRepresentLinUCBTrainer(
        DeepRepresentLinearRegressionUCB(input_dim=c["D"], sizes=c["sizes"],
                                         activations=["relu"] * len(c["sizes"])),
        lr=c["lr"], device=device)


def deep_represent_data(torch, steps, seed, device):
    """The job's reward map, train batches (features, logged arms) and
    greedy evaluation features, drawn on the CPU from ``seed``."""
    c = CB_DEEP
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(c["D"], generator=gen)
    batches = [(torch.randn((c["B"], c["K"], c["D"]), generator=gen),
                torch.randint(0, c["K"], (c["B"], 1), generator=gen)) for _ in range(steps)]
    evals = torch.randn((c["eval_rows"], c["K"], c["D"]), generator=gen)
    return (w.to(device), [(f.to(device), a.to(device)) for f, a in batches], evals.to(device),
            torch.Generator().manual_seed(seed + 1000))


def deep_represent_job(torch, device, steps, seed=0):
    """The JAX test's deep-represent job (D 6, K 4, B 32, trunk [16, 4]
    relu, Adam 3e-3) on ``device`` from CPU draws: the reward |w.x| of the
    logged arm, ``steps`` train steps, then greedy UCB (alpha 0) picks on
    256 rows scored through K3.  Its bars: the last loss under half the
    first, greedy picks over 1.15x the mean reward."""
    from reagent_tpu_torch.core import types as rlt

    w, batches, evals, init_gen = deep_represent_data(torch, steps, seed, device)
    trainer = deep_represent_trainer(torch, device)
    state = trainer.init(init_gen)
    losses = []
    sync(torch, device)
    t0 = time.perf_counter()
    for feats, action in batches:
        rewards_all = (feats @ w).abs()
        state, m = trainer.train_step(state, rlt.CBInput(
            context_arm_features=feats, action=action,
            reward=torch.gather(rewards_all, 1, action)))
        losses.append(m["mse_loss"])
    sync(torch, device)
    train_seconds = time.perf_counter() - t0
    rewards_all = (evals @ w).abs()
    scores = trainer.score(state, rlt.CBInput(context_arm_features=evals), ucb_alpha=0.0)
    picked = torch.gather(rewards_all, 1, scores.argmax(dim=1, keepdim=True))
    losses = torch.stack(losses).cpu().numpy()
    greedy = float(picked.mean()) / float(rewards_all.mean())
    loss_ratio = float(losses[-1] / losses[0])
    return dict(seed=seed, steps=steps, train_seconds=train_seconds,
                steps_per_s=steps / train_seconds, first_loss=float(losses[0]),
                last_loss=float(losses[-1]), loss_ratio=loss_ratio, greedy_ratio=greedy,
                bars_met=bool(loss_ratio < 0.5 and greedy > 1.15))


def mab_draws(torch, T, K, seed, device):
    """The gumbels and reward uniforms of a bandit run, on the CPU from ``seed``."""
    from reagent_tpu_torch.mab.mab_algorithm import gumbel

    gen = torch.Generator().manual_seed(seed)
    return {"gumbels": gumbel((T, K), gen, "cpu").to(device),
            "uniforms": torch.rand(T, generator=gen).to(device)}


def mab_job(torch, device, steps=None, trials=CB_TRIALS):
    """The JAX tests' bandits with their bars (UCB1 on [0.2, 0.8, 0.5] for
    400 steps; MetricUCB, UCBTuned and BernoulliBetaThompson on [0.1, 0.9]
    for 300), each on CPU-drawn gumbels and uniforms (the Thompson draws
    from the device's generator), then compare_bandit_algos over the seven
    algorithms on [0.2, 0.8, 0.5]; ``steps`` cuts every run."""
    from reagent_tpu_torch import mab
    from reagent_tpu_torch.mab import simulation as sim

    out = {}
    total, t_all = 0, 0.0
    for name, (probs, T, seed) in CB_MAB.items():
        T = steps or T
        algo = getattr(mab, name)(n_arms=len(probs))
        sync(torch, device)
        t0 = time.perf_counter()
        regret = sim.single_evaluation_bandit_algo(
            sim.BernoulliMAB(max_steps=T, probs=probs, device=device), algo, seed=seed,
            draws=mab_draws(torch, T, len(probs), seed, device))
        seconds = time.perf_counter() - t0
        total, t_all = total + T, t_all + seconds
        if name == "UCB1":
            bar = bool(regret[-1] - regret[-100] < (regret[99] - regret[0]) * 0.8
                       and regret[-1] < 0.6 * 0.5 * T) if T >= 200 else None
        else:
            bar = bool(regret[-1] < 0.4 * 0.8 * T / 2)
        out[name] = dict(steps=T, seconds=seconds, final_regret=float(regret[-1]), bar_met=bar)
    probs, T, _ = CB_MAB["UCB1"]
    T = steps or T
    t0 = time.perf_counter()
    compared = sim.compare_bandit_algos([getattr(mab, a) for a in CB_ALGOS],
                                        sim.BernoulliMAB(max_steps=T, probs=probs, device=device),
                                        n_trials=trials)
    seconds = time.perf_counter() - t0
    out["compare_bandit_algos"] = dict(
        steps=T, trials=trials, seconds=seconds,
        mean_final_regret={k: float(v[-1]) for k, v in compared.items()})
    out["steps_per_s"] = (total + T * trials * len(CB_ALGOS)) / (t_all + seconds)
    return out


def scaled_diff(got, want):
    """max |got - want| over the largest |want|."""
    got, want = got.detach().cpu(), want.detach().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def cb_scaled(got, want, tol, what):
    """|card - CPU| within ``tol`` of the CPU's largest entry; the ratio."""
    ratio = scaled_diff(got, want)
    if not ratio <= tol:
        raise AssertionError(f"{what}: |card - CPU| / max|CPU| = {ratio:.3e} > {tol}")
    return ratio


def linucb_rows(torch, steps, device):
    """The chosen rows of ``steps`` dynamic-env batches at 500 features under
    a uniform policy, and their rewards and arms, on ``device``."""
    from reagent_tpu_torch.evaluation.cb import DynamicBanditEnv

    cfg = CB_DYNAMIC
    catalogue, draws = dynamic_draws(torch, steps, "cpu")
    env = DynamicBanditEnv(cfg["U"], cfg["B"], cfg["K"], cfg["D"], catalogue=catalogue,
                           device="cpu")
    arms = torch.randint(0, cfg["K"], (steps, cfg["B"]),
                         generator=torch.Generator().manual_seed(5))
    xs, ys, feats = [], [], []
    for i in range(steps):
        obs, rewards_all = env.get_batch(draws[i])
        row = torch.arange(cfg["B"])
        xs.append(obs.context_arm_features[row, arms[i]])
        ys.append(rewards_all[row, arms[i]])
        feats.append(obs.context_arm_features)
    return ([x.to(device) for x in xs], [y.to(device) for y in ys], [a.to(device) for a in arms],
            [f.to(device) for f in feats])


def bandit_card_cpu_phase(torch):
    """Phase 53: the bandit slice card against CPU from one state and the same
    draws; the largest differences by check."""
    from reagent_tpu_torch import mab
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.evaluation.cb import DynamicBanditAgent, DynamicBanditEnv
    from reagent_tpu_torch.evaluation.cb import PolicyEvaluator
    from reagent_tpu_torch.models import linear_regression as lr

    tol = CB_TOL
    worst = {}
    D, K = CB_DYNAMIC["D"], CB_DYNAMIC["K"]
    # the LinUCB update, coefficients and scores, and the disjoint update, at D 500
    rows = {dev: linucb_rows(torch, 25, dev) for dev in (DEVICE, "cpu")}
    model = lr.LinearRegressionUCB(input_dim=D)
    disjoint = lr.DisjointLinearRegressionUCB(num_arms=K, input_dim=D)
    states = {dev: model.init(dev) for dev in rows}
    dstates = {dev: disjoint.init(dev) for dev in rows}
    for i in range(25):
        for dev, (xs, ys, arms, _) in rows.items():
            states[dev] = model.update(states[dev], xs[i], ys[i])
            dstates[dev] = disjoint.update(dstates[dev], arms[i], xs[i], ys[i])
        worst["linucb avg_A"] = mb_close(torch, states[DEVICE].avg_A, states["cpu"].avg_A,
                                         tol["sum"], "LinUCB avg_A")
        worst["linucb avg_b"] = mb_close(torch, states[DEVICE].avg_b, states["cpu"].avg_b,
                                         tol["sum"], "LinUCB avg_b")
    worst["disjoint A"] = mb_close(torch, dstates[DEVICE].A, dstates["cpu"].A, tol["sum"],
                                   "disjoint A")
    worst["disjoint b"] = mb_close(torch, dstates[DEVICE].b, dstates["cpu"].b, tol["sum"],
                                   "disjoint b")
    # both devices solve the CPU's statistics: the pinv alone is compared
    cpu_stats = states["cpu"]
    solved = {dev: model.calculate_coefs(cpu_stats.to(dev)) for dev in rows}
    worst["linucb inv_avg_A (scaled)"] = cb_scaled(solved[DEVICE].inv_avg_A,
                                                   solved["cpu"].inv_avg_A, tol["pinv"],
                                                   "LinUCB inv_avg_A")
    worst["linucb coefs (scaled)"] = cb_scaled(solved[DEVICE].coefs, solved["cpu"].coefs,
                                               tol["pinv"], "LinUCB coefs")
    feats = rows["cpu"][3][-1].reshape(-1, D)
    for key in ("pred_label", "pred_sigma", "ucb"):
        worst[f"linucb {key}"] = mb_close(
            torch, model.forward(solved[DEVICE], feats.to(DEVICE))[key],
            model.forward(solved["cpu"], feats)[key], tol["ucb"], f"LinUCB {key}")
    log(f"  LinUCB at D {D} (25 batches of 4 rows): {worst}")
    # 10 deep-represent steps, each from the CPU's state on both devices:
    # the gradients Adam consumed, recovered from its first moment, held to
    # tol["grad"] of each leaf's largest; Adam turns a gradient that is 0 on
    # one device and a rounding's 1e-8 on the other into a step of up to lr,
    # so a parameter is held within tol["param_lr"] lr where its gradient is
    # over tol["conditioned"] of the leaf's largest, else within 2 lr, and
    # the entries stepped past tol["param_lr"] lr are counted
    w, batches, _, _ = deep_represent_data(torch, 10, 3, "cpu")
    trainers = {dev: deep_represent_trainer(torch, dev) for dev in (DEVICE, "cpu")}
    b1, step_lr = trainers["cpu"].optimizer.b1, CB_DEEP["lr"]
    cpu_state = trainers["cpu"].init(torch.Generator().manual_seed(4))
    dstate, stepped, rounding_level = {}, 0, 0
    for feats, action in batches:
        m = {}
        for dev, tr in trainers.items():
            f, a = feats.to(dev), action.to(dev)
            dstate[dev], m[dev] = tr.train_step(copy_state(cpu_state, dev), rlt.CBInput(
                context_arm_features=f, action=a,
                reward=torch.gather((f @ w.to(dev)).abs(), 1, a)))
        worst["deep mse_loss"] = max(worst.get("deep mse_loss", 0.0), mb_close(
            torch, m[DEVICE]["mse_loss"], m["cpu"]["mse_loss"], tol["loss"],
            f"deep loss at step {int(m['cpu']['num_obs']) // 32}"))
        for k, v in dstate["cpu"].mlp_params.items():
            mu_old = cpu_state.opt_state.mu[k].double()
            g = {dev: (dstate[dev].opt_state.mu[k].cpu().double() - b1 * mu_old) / (1 - b1)
                 for dev in dstate}
            worst[f"deep grad {k} (scaled)"] = max(
                worst.get(f"deep grad {k} (scaled)", 0.0),
                cb_scaled(g[DEVICE], g["cpu"], tol["grad"], f"deep gradient of {k}"))
            conditioned = g["cpu"].abs() > tol["conditioned"] * g["cpu"].abs().max()
            diff = (dstate[DEVICE].mlp_params[k].cpu() - v).abs()
            reach = torch.where(conditioned, tol["param_lr"] * step_lr, 2 * step_lr)
            if not (diff <= reach).all():
                i = int(torch.argmax(diff - reach))
                raise AssertionError(
                    f"deep {k}: entry {i} moved {float(diff.flatten()[i]):.3e} from the "
                    f"CPU's (gradient {float(g['cpu'].flatten()[i]):.3e}, allowed "
                    f"{float(reach.flatten()[i]):.3e})")
            stepped += int((diff > tol["param_lr"] * step_lr).sum())
            rounding_level += int((~conditioned).sum())
            worst[f"deep {k}"] = max(worst.get(f"deep {k}", 0.0), float(diff.max()))
        worst["deep inv_avg_A (scaled)"] = max(
            worst.get("deep inv_avg_A (scaled)", 0.0),
            cb_scaled(dstate[DEVICE].linucb.inv_avg_A, dstate["cpu"].linucb.inv_avg_A,
                      tol["pinv"], "deep inv_avg_A"))
        cpu_state = dstate["cpu"]
    # every stepped entry is one whose gradient is at rounding level
    worst["deep parameter entries stepped apart"] = stepped
    worst["deep parameter entries at rounding level"] = rounding_level
    evals = torch.randn((64, 4, 6), generator=torch.Generator().manual_seed(6))
    worst["deep score"] = mb_close(
        torch, trainers[DEVICE].score(copy_state(cpu_state, DEVICE), rlt.CBInput(
            context_arm_features=evals.to(DEVICE))),
        trainers["cpu"].score(cpu_state, rlt.CBInput(context_arm_features=evals)),
        tol["ucb"], "deep score")
    # every MAB algorithm's scores and choice from one state and the same draws
    gen = torch.Generator().manual_seed(8)
    for name in CB_ALGOS:
        algo = getattr(mab, name)(n_arms=4)
        st = algo.add_batch_observations(algo.init("cpu"), torch.tensor([10.0, 3.0, 7.0, 1.0]),
                                         torch.tensor([6.0, 1.0, 5.0, 1.0]),
                                         torch.tensor([7.8, 1.3, 6.5, 1.3]))
        draws = algo.get_scores(st, generator=gen) if name in (
            "RandomActionsAlgo", "BernoulliBetaThompson") else None
        if name == "NormalGammaThompson":
            draws = torch.stack([mab.mab_algorithm.standard_gamma(st.extra["alpha_0"], gen),
                                 torch.randn(4, generator=gen)])
        card = algo.get_scores(st.to(DEVICE), None if draws is None else draws.to(DEVICE))
        worst[f"mab {name}"] = mb_close(torch, card, algo.get_scores(st, draws), tol["mab"],
                                        f"MAB {name}")
        g = mab.mab_algorithm.gumbel((4,), gen, "cpu")
        if int(algo.action_index(st.to(DEVICE), g.to(DEVICE), None if draws is None
                                 else draws.to(DEVICE))) != int(algo.action_index(st, g, draws)):
            raise AssertionError(f"MAB {name}: the card chose another arm")
    # the replay evaluator's sums over 20 batches
    pe = PolicyEvaluator(max_importance_weight=5.0)
    evs = {dev: pe.init_state(dev) for dev in (DEVICE, "cpu")}
    gen = torch.Generator().manual_seed(9)
    for i in range(20):
        batch = rlt.CBInput(context_arm_features=torch.randn((8, 3, 2), generator=gen),
                            action=torch.randint(0, 3, (8, 1), generator=gen),
                            reward=torch.rand((8, 1), generator=gen),
                            log_prob=torch.log(torch.rand((8, 1), generator=gen) * 0.4 + 0.2),
                            weight=torch.rand((8, 1), generator=gen) + 0.5)
        model_actions = torch.randint(0, 3, (8, 1), generator=gen)
        for dev in evs:
            evs[dev], _ = pe.ingest_batch(evs[dev], batch.to(dev), model_actions.to(dev))
            if i % 5 == 4:
                evs[dev] = pe.aggregate_across_instances(evs[dev])
    for f in evs["cpu"].__dataclass_fields__:
        worst[f"evaluator {f}"] = mb_close(torch, getattr(evs[DEVICE], f),
                                           getattr(evs["cpu"], f), tol["sum"], f"evaluator {f}")
    # the dynamic LinUCB run at 500 features in lockstep: each step's action
    # and next state on the card and, from the card's state, on the CPU; on
    # the CPU's side also a pseudo-inverse at torch's default cutoff, which
    # the inverse's check must tell from JAX's
    steps = 40
    catalogue, draws = dynamic_draws(torch, steps, DEVICE)
    cfg = CB_DYNAMIC
    env = DynamicBanditEnv(cfg["U"], cfg["B"], cfg["K"], D, catalogue=catalogue, device=DEVICE)
    agent = DynamicBanditAgent.make_agent(feature_dim=D, device=DEVICE)
    cpu_agent = DynamicBanditAgent.make_agent(feature_dim=D, device="cpu")
    state = agent.init_state()
    near_ties = worst_coefs = worst_inv = planted_inv = planted_coefs = 0
    at_cutoff, inv_by_step = [], []
    scorer = cpu_agent.trainer.scorer
    rtol = 10 * D * torch.finfo(torch.float32).eps  # JAX's cutoff, as lr.pinv
    for i in range(steps):
        obs, rewards_all = env.get_batch(draws[i])
        action, _ = agent.act(state, obs)
        cpu_state, cpu_obs = state.to("cpu"), obs.to("cpu")
        cpu_action, _ = cpu_agent.act(cpu_state, cpu_obs)
        scores = cpu_agent.trainer.score(cpu_state, cpu_obs)
        top2 = scores.topk(2, dim=1).values
        tie = (top2[:, 0] - top2[:, 1]) <= tol["near_tie"] * top2[:, 0].abs().clamp(min=1.0)
        differ = action.cpu().reshape(-1) != cpu_action.reshape(-1)
        if (differ & ~tie).any():
            raise AssertionError(f"dynamic run step {i}: card {action.reshape(-1).tolist()}, "
                                 f"CPU {cpu_action.reshape(-1).tolist()}, top two {top2}")
        near_ties += int(tie.sum())
        batch = env.add_chosen_action_reward(action.reshape(-1), obs, rewards_all)
        state, _ = agent.learn(state, batch)
        cpu_next, _ = cpu_agent.learn(cpu_state, batch.to("cpu"))
        worst_coefs = max(worst_coefs, cb_scaled(state.coefs, cpu_next.coefs,
                                                 tol["ridge_coefs"],
                                                 f"dynamic run step {i} coefs"))
        updated, _ = cpu_agent.trainer.train_step(cpu_state, batch.to("cpu"))
        A_ext = updated.avg_A + scorer.l2_reg_lambda * torch.eye(D) / updated.sum_weight
        s = torch.linalg.svdvals(A_ext.double())
        if ((s / (rtol * s[0]) - 1).abs() < tol["cutoff_margin"]).any():
            at_cutoff.append(i)
        else:
            inv_by_step.append(cb_scaled(state.inv_avg_A, cpu_next.inv_avg_A, tol["ridge_inv"],
                                         f"dynamic run step {i} inv_avg_A"))
            worst_inv = max(worst_inv, inv_by_step[-1])
        planted = torch.linalg.pinv(A_ext)
        planted_inv = max(planted_inv, scaled_diff(planted, cpu_next.inv_avg_A))
        planted_coefs = max(planted_coefs, scaled_diff(planted @ updated.avg_b, cpu_next.coefs))
    if not planted_inv > tol["ridge_inv"]:
        raise AssertionError(f"dynamic run: a pinv at torch's default cutoff parts from JAX's "
                             f"by {planted_inv:.3e}, within ridge_inv {tol['ridge_inv']}")
    worst["dynamic run coefs (scaled)"] = worst_coefs
    worst["dynamic run inv_avg_A (scaled)"] = worst_inv
    worst["dynamic run planted default-cutoff inv_avg_A (scaled)"] = planted_inv
    worst["dynamic run planted default-cutoff coefs (scaled)"] = planted_coefs
    log(f"  dynamic LinUCB run at D {D}, {steps} steps in lockstep: actions equal; "
        f"{near_ties} rows within {tol['near_tie']} of a tie; the inverse unchecked at "
        f"steps {at_cutoff} (a singular value within {tol['cutoff_margin']} of the cutoff), "
        f"at the others {', '.join(f'{x:.2e}' for x in inv_by_step)} of its largest entry")
    log(f"  largest |card - CPU|: {json.dumps(worst)}")
    return dict(worst, dynamic_near_tie_rows=near_ties)


def linucb_step_ms(torch, device):
    """A LinUCB step's parts at D 500 from the state after 25 batches of 4
    rows: scoring a batch's 40 arms, the update, calculate_coefs and its
    pinv alone; CUDA events on the card (median of 20), the host clock on
    the CPU (median of 5)."""
    from reagent_tpu_torch.models import linear_regression as lr

    D = CB_DYNAMIC["D"]
    xs, ys, _, feats = linucb_rows(torch, 25, device)
    model = lr.LinearRegressionUCB(input_dim=D)
    state = model.init(device)
    for x, y in zip(xs, ys):
        state = model.update(state, x, y)
    state = model.calculate_coefs(state)
    A_ext = state.avg_A + torch.eye(D, device=device) / state.sum_weight
    flat = feats[-1].reshape(-1, D)
    parts = {"score (40 rows)": lambda: model.forward(state, flat),
             "update (4 rows)": lambda: model.update(state, xs[-1], ys[-1]),
             "calculate_coefs (pinv and the product)": lambda: model.calculate_coefs(state),
             "pinv alone (500 x 500)": lambda: lr.pinv(A_ext)}
    if torch.device(device).type == "cuda":
        out = {k: time_ms(torch, fn, sleep_cycles=200_000_000) for k, fn in parts.items()}
    else:
        out = {}
        for k, fn in parts.items():
            fn()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            out[k] = statistics.median(times)
    log(f"  LinUCB at D {D} on {device}: {json.dumps(out)} ms")
    return out


def bandit_timed_phase(torch, name, launch_floor_ms):
    """Phase 54: K3 at the deep-represent score shapes, timed; the LinUCB step
    at D 500 (score, update, coefficients) and its pinv alone (CUDA events,
    median of 20); a whole dynamic-env step, the deep-represent train step
    and score, and a 20-step MAB run (wall, CUDA kernels in a profiled
    window of 3 calls, the idle share, host reads), K3 launched once a
    score call and by no other step."""
    from reagent_tpu_torch import mab
    from reagent_tpu_torch.core import types as rlt
    from reagent_tpu_torch.evaluation.cb import DynamicBanditAgent, DynamicBanditEnv
    from reagent_tpu_torch.mab import simulation as sim

    t0 = time.perf_counter()
    out = {"k3": k3_shapes_phase(torch, name, K3_CB_SHAPES, K3_CB_SHAPES, launch_floor_ms,
                                 sleep_cycles=200_000_000)}
    out["linucb_step_ms"] = linucb_step_ms(torch, DEVICE)
    cfg = CB_DYNAMIC
    D = cfg["D"]
    catalogue, draws = dynamic_draws(torch, 40, DEVICE)
    env = DynamicBanditEnv(cfg["U"], cfg["B"], cfg["K"], D, catalogue=catalogue, device=DEVICE)
    agent = DynamicBanditAgent.make_agent(feature_dim=D, device=DEVICE)
    box = {"s": agent.init_state(), "i": 0}

    def env_step():
        obs, rewards_all = env.get_batch(draws[box["i"] % len(draws)])
        action, _ = agent.act(box["s"], obs)
        box["s"], _ = agent.learn(box["s"], env.add_chosen_action_reward(
            action.reshape(-1), obs, rewards_all))
        box["i"] += 1

    w, batches, evals, init_gen = deep_represent_data(torch, 20, 0, DEVICE)
    trainer = deep_represent_trainer(torch, DEVICE)
    box["d"] = trainer.init(init_gen)

    def deep_step():
        feats, action = batches[box["i"] % len(batches)]
        box["d"], _ = trainer.train_step(box["d"], rlt.CBInput(
            context_arm_features=feats, action=action,
            reward=torch.gather((feats @ w).abs(), 1, action)))
        box["i"] += 1

    def deep_score():
        trainer.score(box["d"], rlt.CBInput(context_arm_features=evals), ucb_alpha=0.0)

    bandit = sim.BernoulliMAB(max_steps=20, probs=[0.2, 0.8, 0.5], device=DEVICE)
    mab_draw = mab_draws(torch, 20, 3, 0, DEVICE)

    def mab_run():
        sim.single_evaluation_bandit_algo(bandit, mab.UCB1(n_arms=3), draws=mab_draw)

    profiled = 3
    for label, fn, n, k3_each in (
            ("dynamic env step at D 500 (score, update, pinv)", env_step, 20, 0),
            ("deep-represent train step (B 32)", deep_step, 20, 0),
            ("deep-represent score (256 x 4 arms, K3)", deep_score, 20, 1),
            ("UCB1 run of 20 steps", mab_run, 10, 0)):
        fn()  # warm
        reset_counts()
        # a profiled window that saw no CUDA kernel lost its events: it is
        # profiled again, and the phase fails after three such windows
        for attempt in range(3):
            wall_ms, dev, kernels, reads, _ = timed_steps(torch, fn, n, label, profiled)
            if kernels > 0:
                break
            log(f"  {label}: the profiled window saw no CUDA kernel")
        else:
            raise AssertionError(f"{label}: three profiled windows saw no CUDA kernel")
        launches, plain = read_counts()
        calls = (attempt + 1) * (n + profiled)
        others = {k: v for k, v in launches.items() if k != "fused_mlp_forward" and v}
        if launches["fused_mlp_forward"] != k3_each * calls or others or plain:
            raise AssertionError(f"{label}: {calls} calls, launches {launches}, plain calls "
                                 f"{plain}")
        out[label] = dict(ms=wall_ms, device_us=dev, kernels=kernels,
                          idle=1 - dev / (wall_ms * 1e3), host_reads=reads,
                          k3_launches_a_call=launches["fused_mlp_forward"] / calls)
        log(f"  [{time.perf_counter() - t0:.1f} s into the phase]")
    log(f"  the steps above on {card_line()}")
    return out


def bandit_jobs_phase(torch):
    """Phase 55: the four bandit jobs cut in depth (CB_CUT; every width
    kept): K3 once for the deep-represent job's greedy score and nowhere
    else, no plain-version call; the bars are read at full depth only
    (tools/cb_jobs.py)."""
    cut = CB_CUT
    out = {}
    for label, run, want in (
            ("dynamic LinUCB", lambda: dynamic_linucb_job(torch, DEVICE, cut["dynamic_steps"]),
             0),
            ("replay evaluation", lambda: replay_eval_job(
                torch, DEVICE, cut["train_steps"], cut["log_batches"], cut["fresh_batches"]), 0),
            ("deep-represent", lambda: deep_represent_job(torch, DEVICE, cut["deep_steps"]), 1),
            ("MAB", lambda: mab_job(torch, DEVICE, cut["mab_steps"], cut["trials"]), 0)):
        reset_counts()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = read_counts()
        others = {k: v for k, v in launches.items() if k != "fused_mlp_forward" and v}
        if launches["fused_mlp_forward"] != want or others or plain:
            raise AssertionError(f"{label}: launches {launches}, plain calls {plain}")
        out[label] = dict(r, seconds=seconds, k3_launches=launches["fused_mlp_forward"])
        log(f"  {label}: {seconds:.2f} s, {json.dumps(r)}")
    log(f"  on {card_line()}")
    return out


# ------------------------------------------------- off-policy estimation

# The CartPole harness (reagent_tpu/ope/test/cartpole.py) on the flagship
# sample config's net (4 -> 128 -> 64 -> 2 leaky_relu) at its defaults of
# 200 episodes and a horizon of 100, the JAX test's temperatures
# (tests/test_ope_benchmarks.py:63-83) and its bar, IPS within half the
# ground truth; an untrained net from the port's seed-0 init
OPE_CARTPOLE = dict(sizes=[128, 64], act="leaky_relu", episodes=200, horizon=100,
                    behavior_temperature=1.5, target_temperature=0.5, gamma=0.99, seed=2)
# NeuralDualDICE on the JAX test's gridworld logs (tests/test_ope.py:80-111:
# a 3 x 3 world, 300 episodes of at most 12 steps, gamma 0.9) at its
# defaults (B 256, hidden 64) for 2,000 steps and the JAX test's 800; its bar
# |estimate - gt| <= max(1, 0.8 |gt|)
OPE_DICE = dict(size=3, episodes=300, max_steps=12, gamma=0.9, steps=2000, test_steps=800,
                batch=256, hidden=64)
# the slate benchmark on QueryCorpus.synthetic() (200 queries of 20 docs, 8
# features) with NNTrainer (500 x 2, its defaults: 100 iterations, B 1,024)
# as the target ranker, and on tests/data/mslr_sample.txt as the JAX test
# drives it (slate size 3, 50 samples a query)
OPE_SLATE = dict(mslr="tests/data/mslr_sample.txt", mslr_slate_size=3, mslr_samples=50)
# the depth of phase 58 (PERF.md section 4): DualDICE's steps; the
# CartPole harness and the slate benchmarks run at full depth
OPE_CUT = dict(dice_steps=200)
# card against CPU (phase 56): NNTrainer 20 iterations at 500 x 2, B 1,024;
# the MSLR slate job; DualDICE 20 steps; the CartPole
# harness from one tape of draws
OPE_LOCKSTEP = dict(nn_iterations=20, dice_steps=20)
# losses, K3's plain version against the card's kernel and float32 sums in
# another order; the parameters as the CPU tests hold them to JAX's (every
# entry, each net's leaves); near-tie: the top two of logits + gumbel within
# 1e-3 of each other on the CPU's side.  The CartPole states and propensities
# on the valid steps (after an episode's end the env steps on with its pole
# fallen, and the two sides drift apart there unchecked).  ``estimate``
# holds the CartPole and the MSLR slate estimates, relative
OPE_TOL = dict(loss=dict(rtol=1e-4, atol=1e-6), param=dict(rtol=5e-4, atol=5e-5),
               pred=dict(rtol=1e-3, atol=1e-3), estimate=1e-4, magic=2e-4,
               states=dict(rtol=1e-4, atol=1e-4), near_tie=1e-3)


def k3_ope_shapes():
    """K3 at the slice's shapes, taken from the jobs' own inputs: NNTrainer's
    predict (500 x 2, streamed) over every doc of QueryCorpus.synthetic() and
    of the MSLR sample, the CartPole harness's act step at its episodes and
    its Q scoring over episodes x horizon logged states (resident),
    DualDICE's zeta forward over the gridworld logs' valid steps (resident)."""
    from reagent_tpu_torch.ope.estimators.sequential_estimators import NeuralDualDICE

    def docs(corpus):
        Q, M, D = slate_corpus(corpus)[0].features.shape
        return Q * M, D

    logs = gridworld_logs()
    dice_s = NeuralDualDICE(state_dim=logs.states.shape[2], num_actions=4,
                            device="cpu").data(logs).s
    N, T = OPE_CARTPOLE["episodes"], OPE_CARTPOLE["horizon"]
    relu = ["relu", "relu", "linear"]
    nn = ([500, 500, 1], relu, False)
    q = (OPE_CARTPOLE["sizes"] + [2], [OPE_CARTPOLE["act"]] * 2 + ["linear"], True)
    zeta = ([OPE_DICE["hidden"]] * 2 + [4], relu, True)
    shapes = {}
    for label, rows, dim, (sizes, acts, resident) in (
            ("NNTrainer predict, synthetic corpus", *docs("synthetic"), nn),
            ("NNTrainer predict, MSLR sample", *docs("mslr"), nn),
            ("CartPole act", N, 4, q),
            ("CartPole Q scoring", N * T, 4, q),
            ("DualDICE zeta, valid steps", *dice_s.shape, zeta)):
        widths = [dim] + sizes
        shapes[f"{label} [{rows}, {'->'.join(map(str, widths))}]"] = (
            rows, widths, acts, resident, 141 + len(shapes))
    return shapes


def ope_cartpole_net(torch, device):
    """The flagship sample config's Q-network from the port's seed-0 init."""
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training import functional

    cfg = OPE_CARTPOLE
    net = FullyConnectedDQN(4, 2, cfg["sizes"], [cfg["act"]] * len(cfg["sizes"]),
                            generator=torch.Generator().manual_seed(0)).to(device)
    return net, functional.params_of(net)


def ope_cartpole_draws(torch, episodes, horizon, seed):
    """The logging and target rollouts' draws, made on the CPU from ``seed``."""
    from reagent_tpu_torch.gym.envs.functional import CartPole
    from reagent_tpu_torch.ope.test import cartpole

    gen = torch.Generator().manual_seed(seed)
    env = CartPole(device="cpu")
    return tuple(cartpole.draw_rollout_noise(env, episodes, horizon, gen) for _ in range(2))


def cartpole_ope_job(torch, device, episodes=None, horizon=None, seed=None, draws=None,
                     with_logs=False):
    """The CartPole harness: IPS, DR and MAGIC against the target policy's
    simulated value; the JAX test's bar, IPS within half the ground truth.
    With ``with_logs``, (that, the logged rollout as numpy arrays)."""
    from reagent_tpu_torch.ope.test import cartpole

    cfg = OPE_CARTPOLE
    episodes, horizon = episodes or cfg["episodes"], horizon or cfg["horizon"]
    seed = cfg["seed"] if seed is None else seed
    net, params = ope_cartpole_net(torch, device)
    if draws is None:
        draws = ope_cartpole_draws(torch, episodes, horizon, seed)
    results, gt, logs = cartpole.evaluate_cartpole(
        net, params, behavior_temperature=cfg["behavior_temperature"],
        target_temperature=cfg["target_temperature"], num_episodes=episodes, horizon=horizon,
        gamma=cfg["gamma"], draws=draws, device=device, return_logs=True)
    est = {k: v.estimated_reward for k, v in results.items()}
    if not all(np.isfinite(v) for v in est.values()):
        raise AssertionError(f"CartPole OPE on {device}: estimates {est}")
    out = dict(gt=gt, log_reward=results["ips"].log_reward, **est,
               ips_bar_met=bool(abs(est["ips"] - gt) < 0.5 * gt))
    return (out, logs) if with_logs else out


_GRIDWORLD_LOGS = {}


def gridworld_logs(episodes=None):
    """The JAX test's gridworld logs (numpy, on the host; made once)."""
    from reagent_tpu_torch.ope.test.gridworld import GridWorld, generate_logs
    from reagent_tpu_torch.ope.trainers.rl_tabular_trainers import (
        DPTrainer,
        DPValueFunction,
        TabularPolicy,
    )

    cfg = OPE_DICE
    episodes = episodes or cfg["episodes"]
    if episodes not in _GRIDWORLD_LOGS:
        world = GridWorld(size=cfg["size"])
        tgt = TabularPolicy(world.num_actions, epsilon=0.1)
        DPTrainer(world, tgt).train(gamma=cfg["gamma"])
        log_policy = TabularPolicy(world.num_actions, epsilon=0.6)
        for s in world.states:
            log_policy.update(s, int(np.argmax(tgt.action_dist(s))))
        value_fn = DPValueFunction(tgt, world, cfg["gamma"])
        value_fn.evaluate()
        logs = generate_logs(world, log_policy, tgt, value_fn, num_episodes=episodes,
                             max_steps=cfg["max_steps"], gamma=cfg["gamma"])
        logs.ground_truth_reward = value_fn.state_value((0, 0))
        _GRIDWORLD_LOGS[episodes] = logs
    return _GRIDWORLD_LOGS[episodes]


def dualdice(torch, device, steps):
    from reagent_tpu_torch.ope.estimators.sequential_estimators import NeuralDualDICE

    cfg = OPE_DICE
    logs = gridworld_logs()
    return NeuralDualDICE(state_dim=logs.states.shape[2], num_actions=4,
                          hidden_dim=cfg["hidden"], training_samples=steps,
                          batch_size=cfg["batch"], device=device), logs


def dualdice_job(torch, device, steps, seed=0):
    """NeuralDualDICE on the gridworld logs from a CPU generator seeded
    ``seed`` (init and indices); the JAX test's bar."""
    est, logs = dualdice(torch, device, steps)
    gt = logs.ground_truth_reward
    t0 = time.perf_counter()
    res = est.evaluate(logs, generator=torch.Generator().manual_seed(seed))
    seconds = time.perf_counter() - t0
    if not np.isfinite(res.estimated_reward):
        raise AssertionError(f"DualDICE on {device}: {res}")
    return dict(steps=steps, gt=gt, estimate=res.estimated_reward,
                steps_per_s=steps / seconds,
                bar_met=bool(abs(res.estimated_reward - gt) <= max(1.0, 0.8 * abs(gt))))


def slate_corpus(corpus):
    """(QueryCorpus.synthetic() or the MSLR sample, the benchmark's options
    for it)."""
    from reagent_tpu_torch.ope.test import slate_benchmark as sb

    if corpus == "synthetic":
        return sb.QueryCorpus.synthetic(), {}
    return sb.QueryCorpus.from_mslr(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), OPE_SLATE["mslr"])), dict(slate_size=OPE_SLATE["mslr_slate_size"],
                                              num_samples_per_query=OPE_SLATE["mslr_samples"])


def slate_job(torch, device, corpus):
    """The slate benchmark with NNTrainer as the target ranker, on
    ``QueryCorpus.synthetic()`` or the MSLR sample; IPS, PBM and the
    pseudo-inverse estimate against the closed-form ground truth."""
    from reagent_tpu_torch.ope.test import slate_benchmark as sb
    from reagent_tpu_torch.ope.trainers import NNTrainer

    data, kw = slate_corpus(corpus)
    res = sb.evaluate_slate_benchmark(data, tgt_trainer=NNTrainer(seed=0, device=device), **kw)
    est = {k: v.estimated_reward for k, v in res.items()}
    if not all(np.isfinite(v) for v in est.values()):
        raise AssertionError(f"slate benchmark ({corpus}) on {device}: {est}")
    return dict(gt=res["ips"].ground_truth_reward, log_reward=res["ips"].log_reward, **est,
                std_errors={k: v.estimated_reward_std_error for k, v in res.items()})


def ope_nn_data(torch):
    """NNTrainer's training split of QueryCorpus.synthetic(), as the slate
    benchmark's ``train_ranker_scores`` makes it."""
    from reagent_tpu_torch.ope.test import slate_benchmark as sb
    from reagent_tpu_torch.ope.trainers import TrainingData

    corpus = sb.QueryCorpus.synthetic()
    Q, M, D = corpus.features.shape
    train_q = np.random.default_rng(1).permutation(Q)[: Q // 2]
    return TrainingData(corpus.features[train_q].reshape(-1, D),
                        corpus.relevances[train_q].reshape(-1)), corpus.features.reshape(-1, D)


def ope_card_cpu_phase(torch):
    """Phase 56: the OPE slice card against CPU: NNTrainer from one seed,
    the MSLR slate job (NNTrainer its target ranker), NeuralDualDICE from
    one init and one set of indices, the CartPole harness from one tape of
    draws; the largest differences by check."""
    from reagent_tpu_torch.ope.trainers import NNTrainer

    tol, worst = OPE_TOL, {}
    n_it = OPE_LOCKSTEP["nn_iterations"]
    data, xv = ope_nn_data(torch)
    nn = {dev: NNTrainer(seed=0, device=dev) for dev in (DEVICE, "cpu")}
    for t in nn.values():
        t.train(data, iterations=n_it)
    worst["NNTrainer losses"] = mb_close(torch, torch.stack(nn[DEVICE].losses),
                                         torch.stack(nn["cpu"].losses), tol["loss"],
                                         "NNTrainer losses")
    for k in nn["cpu"].params:
        worst[f"NNTrainer {k}"] = mb_close(torch, nn[DEVICE].params[k], nn["cpu"].params[k],
                                           tol["param"], f"NNTrainer {k}")
    pred = {dev: t.predict(xv) for dev, t in nn.items()}
    np.testing.assert_allclose(pred[DEVICE], pred["cpu"], **tol["pred"])
    worst["NNTrainer predictions"] = float(np.abs(pred[DEVICE] - pred["cpu"]).max())
    if nn[DEVICE].lr != nn["cpu"].lr:
        raise AssertionError(f"NNTrainer LR {nn[DEVICE].lr} on the card, {nn['cpu'].lr}")
    # the MSLR slate job: its target ranker's scores are one K3 launch
    slate = {dev: slate_job(torch, dev, "mslr") for dev in (DEVICE, "cpu")}
    for k in ("gt", "ips", "pbm", "pseudo_inverse"):
        rel = abs(slate[DEVICE][k] - slate["cpu"][k]) / abs(slate["cpu"][k])
        if rel > tol["estimate"]:
            raise AssertionError(f"MSLR slate {k}: card {slate[DEVICE][k]}, "
                                 f"CPU {slate['cpu'][k]}")
        worst[f"MSLR slate {k} (relative)"] = rel

    steps = OPE_LOCKSTEP["dice_steps"]
    dice = {dev: dualdice(torch, dev, steps)[0] for dev in (DEVICE, "cpu")}
    logs = gridworld_logs()
    gen = torch.Generator().manual_seed(5)
    params = (dice["cpu"].init_params(gen), dice["cpu"].init_params(gen))
    indices = dice["cpu"].draw_indices(dice["cpu"].data(logs), gen)
    est = {dev: d.evaluate(logs, params=params, indices=indices).estimated_reward
           for dev, d in dice.items()}
    if abs(est[DEVICE] - est["cpu"]) > tol["estimate"] * abs(est["cpu"]):
        raise AssertionError(f"DualDICE estimate: card {est[DEVICE]}, CPU {est['cpu']}")
    worst["DualDICE estimate (relative)"] = abs(est[DEVICE] - est["cpu"]) / abs(est["cpu"])
    for net in ("nu", "zeta"):
        for k, v in getattr(dice["cpu"].last_state, net).items():
            worst[f"DualDICE {net} {k}"] = mb_close(
                torch, getattr(dice[DEVICE].last_state, net)[k], v, tol["param"],
                f"DualDICE {net} {k}")

    log(f"  NNTrainer and DualDICE: {json.dumps(worst)}")
    cfg = OPE_CARTPOLE
    N, T = cfg["episodes"], cfg["horizon"]
    draws = ope_cartpole_draws(torch, N, T, 11)
    rollouts, jobs = {}, {}
    for dev in (DEVICE, "cpu"):
        jobs[dev], rollouts[dev] = cartpole_ope_job(torch, dev, N, T, draws=draws,
                                                    with_logs=True)
    a, b = rollouts[DEVICE]["actions"], rollouts["cpu"]["actions"]
    parted = np.argwhere(a != b)
    if len(parted):
        # the first parting must be a near-tie of the CPU's logits + gumbels
        e, t = parted[0]
        logits = rollouts["cpu"]["propensities"][e, t]
        g = draws[0].gumbels[e, t].numpy()
        z = np.sort(np.log(logits) + g)
        if z[-1] - z[-2] > tol["near_tie"]:
            raise AssertionError(f"CartPole actions part at episode {e}, step {t} off a tie")
        log(f"  CartPole rollout: actions part at a near-tie (episode {e}, step {t}); "
            "the estimates are not compared")
    else:
        # the valid steps held; after an episode ends the env steps on, its
        # pole fallen, and the two sides' states drift further apart
        valid = rollouts["cpu"]["mask"] > 0
        for k in ("states", "propensities"):
            got, want = rollouts[DEVICE][k], rollouts["cpu"][k]
            np.testing.assert_allclose(got[valid], want[valid], **tol["states"])
            worst[f"CartPole {k}, valid steps"] = float(np.abs(got - want)[valid].max())
            worst[f"CartPole {k}, after the end"] = float(np.abs(got - want)[~valid].max(
                initial=0.0))
        for k in ("ips", "dr", "magic", "gt"):
            rel = abs(jobs[DEVICE][k] - jobs["cpu"][k]) / abs(jobs["cpu"][k])
            if rel > (tol["magic"] if k == "magic" else tol["estimate"]):
                raise AssertionError(f"CartPole {k}: card {jobs[DEVICE][k]}, "
                                     f"CPU {jobs['cpu'][k]}")
            worst[f"CartPole {k} (relative)"] = rel
    worst["CartPole actions parted"] = int(len(parted))
    log(f"  {json.dumps(worst)}")
    return worst


def ope_timed_phase(torch, name, launch_floor_ms):
    """Phase 57: K3 at the slice's shapes against its plain version and one
    torch.addmm a layer, timed; NNTrainer's train steps/s at its defaults;
    a DualDICE step at B 256, hidden 64 (wall, CUDA kernels, the idle
    share, 0 host reads or the script fails); the CartPole harness's ms a
    rollout step at 200 episodes (the same, K3 once a step)."""
    from reagent_tpu_torch.ope.test import cartpole
    from reagent_tpu_torch.ope.trainers import NNTrainer

    t0 = time.perf_counter()
    shapes = k3_ope_shapes()
    out = {"k3": k3_shapes_phase(torch, name, shapes, shapes, launch_floor_ms,
                                 sleep_cycles=200_000_000)}
    data, _ = ope_nn_data(torch)
    trainer = NNTrainer(seed=0, device=DEVICE)
    trainer.train(data, iterations=10)  # warm
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    trainer.train(data)
    torch.cuda.synchronize()
    out["NNTrainer train steps/s (100 iterations, B 1,024, 500 x 2)"] = 100 / (
        time.perf_counter() - t1)
    log(f"  NNTrainer: {out['NNTrainer train steps/s (100 iterations, B 1,024, 500 x 2)']:.2f} "
        "train steps/s at its defaults (a host read every 10 steps)")

    est, logs = dualdice(torch, DEVICE, 1)
    dice_data = est.data(logs)
    gen = torch.Generator().manual_seed(0)
    box = {"s": est.init(est.init_params(gen), est.init_params(gen)), "i": 0}
    idx, i0 = est.draw_indices(dice_data, gen)

    def dice_step():
        box["s"] = est.step(dice_data, box["s"], idx[0], i0[0])

    cfg = OPE_CARTPOLE
    N, T = cfg["episodes"], cfg["horizon"]
    net, params = ope_cartpole_net(torch, DEVICE)
    env = cartpole.CartPole(max_steps=T, device=DEVICE)
    draws = ope_cartpole_draws(torch, N, T, 3)[0].to(DEVICE)
    scores = cartpole.q_scores(net, params)

    def rollout():
        cartpole._rollout(env, scores, cfg["behavior_temperature"], N, T, draws)

    profiled = 3
    for label, fn, n, k3_each, per in (
            ("DualDICE step (B 256, hidden 64)", dice_step, 20, 0, 1),
            (f"CartPole rollout ({N} episodes x {T} steps)", rollout, 3, T, T)):
        fn()  # warm
        reset_counts()
        for attempt in range(3):
            wall_ms, dev, kernels, reads, _ = timed_steps(torch, fn, n, label, profiled)
            if kernels > 0:
                break
            log(f"  {label}: the profiled window saw no CUDA kernel")
        else:
            raise AssertionError(f"{label}: three profiled windows saw no CUDA kernel")
        launches, plain = read_counts()
        calls = (attempt + 1) * (n + profiled)
        others = {k: v for k, v in launches.items() if k != "fused_mlp_forward" and v}
        if launches["fused_mlp_forward"] != k3_each * calls or others or plain:
            raise AssertionError(f"{label}: {calls} calls, launches {launches}, plain {plain}")
        if reads:
            raise AssertionError(f"{label}: {reads} host reads a call")
        out[label] = dict(ms_a_step=wall_ms / per, device_us_a_step=dev / per,
                          kernels_a_step=kernels / per, idle=1 - dev / (wall_ms * 1e3),
                          host_reads_a_step=reads / per, k3_launches_a_step=k3_each / per)
        log(f"  {label}: {json.dumps(out[label])}")
    out["DualDICE steps/s"] = 1e3 / out["DualDICE step (B 256, hidden 64)"]["ms_a_step"]
    log(f"  [{time.perf_counter() - t0:.1f} s into the phase] on {card_line()}")
    return out


def ope_jobs_phase(torch):
    """Phase 58: the OPE jobs cut in depth (OPE_CUT): the CartPole harness
    (K3 once an act step of each rollout and once over the logged states),
    DualDICE on the gridworld (K3 once, the zeta forward), the slate
    benchmark on QueryCorpus.synthetic() and on the MSLR sample (K3 once,
    NNTrainer's predict); no other kernel, no plain-version call."""
    cfg = OPE_CARTPOLE
    out = {}
    for label, run, want in (
            ("CartPole harness", lambda: cartpole_ope_job(torch, DEVICE), 2 * cfg["horizon"] + 1),
            ("DualDICE on the gridworld", lambda: dualdice_job(
                torch, DEVICE, OPE_CUT["dice_steps"]), 1),
            ("slate benchmark, synthetic corpus", lambda: slate_job(torch, DEVICE, "synthetic"),
             1),
            ("slate benchmark, MSLR sample", lambda: slate_job(torch, DEVICE, "mslr"), 1)):
        reset_counts()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = read_counts()
        others = {k: v for k, v in launches.items() if k != "fused_mlp_forward" and v}
        if launches["fused_mlp_forward"] != want or others or plain:
            raise AssertionError(f"{label}: launches {launches}, plain calls {plain}")
        out[label] = dict(r, seconds=seconds, k3_launches=launches["fused_mlp_forward"])
        log(f"  {label}: {seconds:.2f} s, {json.dumps(r)}")
    log(f"  on {card_line()}")
    return out


# The imitation, counterfactual-evaluation, gradient-free and parallel slice
# (phases 60-62) at the offline full width (bench.py:286-287): the
# behavioural-cloning and bandit reward nets are FullyConnectedDQN
# 128->512->256->8 (FULL's activations), B 4,096; Bayes by backprop a
# BayesianMLP over the state and the action's one-hot, 136->512->1, with 32
# Monte-Carlo samples (predict_with_uncertainty's default); the ES pool at
# EvolutionParameters' default population of 1,000 over a vector of the
# flagship net's 9,026 parameters (4->128->64->2).  Depths cut to 5 steps
# card against CPU, 20 timed steps and iterations (PERF.md section 4).
IMIT = dict(bbb_hidden=512, samples=32, drop_threshold=0.3, steps=5, timed_steps=20,
            lr=1e-3, kl_weight=1e-3)
ES_SLICE = dict(params=9026, iterations=5, timed=20, profiled=3, epochs=3)
PARALLEL = dict(steps=5, scaling_steps=20)
# losses and the K3 outputs as elsewhere; the parameters and moments as
# phases 44 and 56 hold them
IMIT_TOL = dict(loss=dict(rtol=1e-4, atol=1e-6), param=dict(rtol=5e-4, atol=5e-5),
                k3=dict(rtol=1e-5, atol=1e-5))


def imitation_trainer(torch, label, device):
    """The slice's three trainers at the full offline width."""
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training.behavioral_cloning_trainer import BehavioralCloningTrainer
    from reagent_tpu_torch.training.cfeval import BanditRewardNetTrainer, BayesByBackpropTrainer
    from reagent_tpu_torch.training.cfeval.bayes_by_backprop_trainer import BayesianMLP

    opt = {"Adam": {"lr": IMIT["lr"]}}
    if label == "Bayes by backprop":
        net = BayesianMLP(FULL["D"] + FULL["A"], IMIT["bbb_hidden"], 1)
        return BayesByBackpropTrainer(net, opt, kl_weight=IMIT["kl_weight"], device=device)
    net = FullyConnectedDQN(FULL["D"], FULL["A"], FULL["widths"],
                            [FULL["act"]] * len(FULL["widths"]))
    if label == "behavioral cloning":
        return BehavioralCloningTrainer(net, opt, device=device)
    return BanditRewardNetTrainer(net, opt, weighted_by_inverse_propensity=True, device=device)


IMIT_TRAINERS = ("behavioral cloning", "bandit reward net (IPS)", "Bayes by backprop")


def imitation_batch(torch, label, seed, device):
    """A logged batch of B 4,096 at the full width for ``label``'s trainer:
    states, one-hot actions (a possible-actions mask with every logged
    action possible for behavioural cloning), rewards, propensities."""
    from reagent_tpu_torch.core import types as rlt

    rng = np.random.default_rng(seed)
    B, D, A = FULL["B"], FULL["D"], FULL["A"]
    actions = rng.integers(0, A, B)
    state = rlt.FeatureData(float_features=torch.tensor(
        rng.normal(size=(B, D)).astype(np.float32)))
    action = torch.tensor(np.eye(A, dtype=np.float32)[actions])
    if label == "behavioral cloning":
        mask = (rng.random((B, A)) > 0.2).astype(np.float32)
        mask[np.arange(B), actions] = 1.0
        batch = rlt.BehavioralCloningModelInput(state=state, action=action,
                                                possible_actions_mask=torch.tensor(mask))
    else:
        batch = rlt.BanditRewardModelInput(
            state=state, action=action,
            reward=torch.tensor((actions / A + rng.normal(size=B) * 0.1).astype(np.float32)),
            action_prob=torch.tensor(rng.uniform(0.05, 1.0, (B, 1)).astype(np.float32)))
    return batch.to(device)


def imitation_step(trainer, state, batch, eps):
    if eps is None:
        return trainer.train_step(state, batch)
    return trainer.train_step(state, batch, eps)


def one_max_pool(torch, device, seed=0, **kw):
    """``OneMaxEvolutionPool`` at EvolutionParameters' defaults over a vector
    of the flagship net's size."""
    from reagent_tpu_torch.core.parameters import EvolutionParameters
    from reagent_tpu_torch.training.gradient_free import OneMaxEvolutionPool

    return OneMaxEvolutionPool(seed, EvolutionParameters(), {"data": [ES_SLICE["params"]]},
                               device=device, **kw)


def imitation_card_cpu_phase(torch, n=IMIT["steps"]):
    """Phase 60: ``n`` steps of behavioural cloning, the IPS-weighted bandit
    reward net and Bayes by backprop (one weight noise a step, drawn on the
    CPU) card against CPU from one state on the same batches, then ``n``
    EvolutionPool iterations from one parent and the same mutations; no
    K1-K5 launch (the steps' forwards are autograd's)."""
    from reagent_tpu_torch.training.cfeval.bayes_by_backprop_trainer import BayesianMLP

    reset_counts()
    worst = {}
    for i, label in enumerate(IMIT_TRAINERS):
        trainers = {d: imitation_trainer(torch, label, d) for d in ("cpu", DEVICE)}
        first = trainers["cpu"].init(torch.Generator().manual_seed(90 + i))
        states = {d: copy_state(first, d) for d in trainers}
        noise = torch.Generator().manual_seed(95 + i)
        worst_l = 0.0
        for step in range(n):
            net = getattr(trainers["cpu"], "net", None)
            eps = net.draw_noise(noise) if isinstance(net, BayesianMLP) else None
            metrics = {}
            for d, tr in trainers.items():
                states[d], m = imitation_step(
                    tr, states[d], imitation_batch(torch, label, 900 + step, d),
                    None if eps is None else [e.to(d) for e in eps])
                metrics[d] = {k: v.cpu() for k, v in m.items()}
            for k, want in metrics["cpu"].items():
                worst_l = max(worst_l, mb_close(torch, metrics[DEVICE][k], want,
                                                IMIT_TOL["loss"], f"{label} {k}"))
        count, worst_p = compare_states(torch, states[DEVICE], states["cpu"], IMIT_TOL["param"],
                                        label)
        worst[label] = dict(metrics=worst_l, state=worst_p, state_tensors=count)
        log(f"  {label}, {n} steps at B {FULL['B']}: metrics max abs {worst_l:.3e}, {count} "
            f"state tensors max abs {worst_p:.3e}")
    parent = {"data": torch.randn(ES_SLICE["params"], generator=torch.Generator().manual_seed(97))}
    first = one_max_pool(torch, "cpu", seed=98).state().noise
    pools = {d: one_max_pool(torch, d, parent_tensors=parent, noise=first)
             for d in ("cpu", DEVICE)}
    worst_r = 0.0
    for it in range(ES_SLICE["iterations"]):
        rewards = {d: pool.compute_rewards() for d, pool in pools.items()}
        worst_r = max(worst_r, mb_close(torch, rewards[DEVICE], rewards["cpu"],
                                        IMIT_TOL["loss"], "ES rewards"))
        noise = pools["cpu"].draw_noise()
        for d, pool in pools.items():
            pool.apply_global_reward(rewards[d], it + 1, noise=noise)
    worst_es = mb_close(torch, pools[DEVICE].parent_tensors["data"],
                        pools["cpu"].parent_tensors["data"], IMIT_TOL["param"], "ES parent")
    worst["EvolutionPool"] = dict(rewards=worst_r, parent=worst_es)
    log(f"  OneMaxEvolutionPool, population 1,000 x {ES_SLICE['params']}, "
        f"{ES_SLICE['iterations']} iterations from one parent and the same mutations: rewards "
        f"max abs {worst_r:.3e}, parent max abs {worst_es:.3e}")
    launches, plain = read_counts()
    if any(launches.values()) or plain:
        raise AssertionError(f"phase 60: launches {launches}, plain calls {plain}")
    return worst


def imitation_timed_phase(torch, name, launch_floor_ms):
    """Phase 61: K3 on the imitator gate at [4,096, 128->512->256->8] (one
    launch, the mask equal to the plain version's away from the threshold)
    and on each of Bayes by backprop's 32 samples at [4,096, 136->512->1]
    (32 launches; each sample and the mean and std held to the plain
    version), both timed beside one torch.addmm a layer, the launch floor
    and the bound; the three trainers' train steps/s; the ES pool's
    iterations/s with a profiled window (CUDA kernels, the idle share, host
    reads: the std guard's one)."""
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.ops import fused_mlp
    from reagent_tpu_torch.training import functional
    from reagent_tpu_torch.training.cfeval.bayes_by_backprop_trainer import ACTIVATIONS
    from reagent_tpu_torch.training.imitator_training import get_valid_actions_from_imitator

    t0 = time.perf_counter()
    out = {"k3": {}}
    B, D, A, S = FULL["B"], FULL["D"], FULL["A"], IMIT["samples"]
    gen = torch.Generator().manual_seed(101)
    net = FullyConnectedDQN(D, A, FULL["widths"], [FULL["act"]] * len(FULL["widths"]),
                            generator=gen).to(DEVICE)
    params = functional.params_of(net)
    x = torch.randn(B, D, generator=gen).to(DEVICE)
    thr = IMIT["drop_threshold"]
    reset_counts()
    mask = get_valid_actions_from_imitator((net, params), x, thr)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    if launches["fused_mlp_forward"] != 1 or plain or sum(launches.values()) != 1:
        raise AssertionError(f"imitator gate: launches {launches}, plain calls {plain}")
    weights = functional.k3_weights(params, "net", len(net.net.layers))
    logits = fused_mlp.fused_mlp_forward_reference(x, weights, net.activations)
    probs = torch.softmax(logits, dim=1)
    filt = probs / probs.amax(dim=1, keepdim=True)
    away = (filt - thr).abs() > 1e-4
    if not torch.equal(mask[away], (filt >= thr).to(torch.float32)[away]):
        raise AssertionError("imitator gate: the mask parts from the plain version's")
    label = f"imitator gate [{B}, {D}->{'->'.join(map(str, FULL['widths']))}->{A}]"
    out["k3"][label] = k3_row(torch, name, label, x, weights, net.activations, launch_floor_ms,
                              sleep_cycles=200_000_000)
    out["k3"][label]["launches_a_call"] = 1
    log(f"  imitator gate: 1 K3 launch, {int(mask.sum())} of {mask.numel()} actions viable, "
        f"{int((~away).sum())} within 1e-4 of the threshold")

    bbb = imitation_trainer(torch, "Bayes by backprop", DEVICE)
    bstate = bbb.init(torch.Generator().manual_seed(102))
    xb = torch.randn(B, D + A, generator=gen).to(DEVICE)
    eps = [e.to(DEVICE) for e in bbb.net.draw_noise(torch.Generator().manual_seed(103), S)]
    reset_counts()
    mean, std = bbb.predict_with_uncertainty(bstate, xb, S, eps)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    if launches["fused_mlp_forward"] != S or plain or sum(launches.values()) != S:
        raise AssertionError(f"BBB predictions: launches {launches}, plain calls {plain}")
    samples = []
    worst = 0.0
    for s in range(S):
        w = bbb.sampled_weights(bstate.params, eps, s)
        y = fused_mlp.fused_mlp_forward(xb, w, ACTIVATIONS)
        yp = fused_mlp.fused_mlp_forward_reference(xb, w, ACTIVATIONS)
        torch.testing.assert_close(y, yp, **IMIT_TOL["k3"])
        worst = max(worst, (y - yp).abs().max().item())
        samples.append(yp)
    plain_preds = torch.stack(samples)
    torch.testing.assert_close(mean, plain_preds.mean(0), **IMIT_TOL["k3"])
    torch.testing.assert_close(std, plain_preds.std(0, correction=0), **IMIT_TOL["k3"])
    label = f"Bayes-by-backprop sample [{B}, {D + A}->{IMIT['bbb_hidden']}->1]"
    out["k3"][label] = k3_row(torch, name, label, xb, bbb.sampled_weights(bstate.params, eps, 0),
                              list(ACTIVATIONS), launch_floor_ms, sleep_cycles=200_000_000)
    out["k3"][label]["launches_a_call"] = S
    out["k3"][label]["max_abs_err_over_samples"] = worst
    out["predict_with_uncertainty ms (32 samples)"] = time_ms(
        torch, lambda: bbb.predict_with_uncertainty(bstate, xb, S, eps), iters=10,
        sleep_cycles=200_000_000)
    log(f"  BBB predictions: {S} K3 launches, each sample max abs {worst:.3e} against the plain "
        f"version; predict_with_uncertainty "
        f"{out['predict_with_uncertainty ms (32 samples)']:.4f} ms of device time")

    for i, label in enumerate(IMIT_TRAINERS):
        tr = imitation_trainer(torch, label, DEVICE)
        box = {"s": tr.init(torch.Generator().manual_seed(110 + i))}
        batch = imitation_batch(torch, label, 910 + i, DEVICE)

        def step(tr=tr, box=box, batch=batch):
            box["s"], _ = tr.train_step(box["s"], batch)

        step()  # warm
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(IMIT["timed_steps"]):
            step()
        torch.cuda.synchronize()
        out[f"{label} train steps/s (B {B})"] = IMIT["timed_steps"] / (time.perf_counter() - t1)
        log(f"  {label}: {out[f'{label} train steps/s (B {B})']:.2f} train steps/s")

    pool = one_max_pool(torch, DEVICE)
    it = {"n": 0}

    def iteration():
        it["n"] += 1
        pool.apply_global_reward(pool.compute_rewards(), it["n"])

    iteration()  # warm
    reset_counts()
    wall_ms, dev, kernels, reads, _ = timed_steps(
        torch, iteration, ES_SLICE["timed"], "OneMaxEvolutionPool iteration (1,000 x 9,026)",
        ES_SLICE["profiled"])
    launches, plain = read_counts()
    if any(launches.values()) or plain or reads != 1:
        raise AssertionError(f"ES iteration: launches {launches}, plain {plain}, reads {reads}")
    out["OneMaxEvolutionPool"] = dict(iterations_per_s=1e3 / wall_ms, ms_an_iteration=wall_ms,
                                      device_us_an_iteration=dev, kernels_an_iteration=kernels,
                                      idle=1 - dev / (wall_ms * 1e3), host_reads=reads)
    log(f"  OneMaxEvolutionPool: {json.dumps(out['OneMaxEvolutionPool'])}")
    log(f"  [{time.perf_counter() - t0:.1f} s into the phase] on {card_line()}")
    return out


def full_width_dqn_batch(torch, seed, device):
    """A DQN batch at the full offline width (phase 24's)."""
    from reagent_tpu_torch.core import types as rlt

    _, b, _ = make_inputs(FULL, seed, torch, "cpu")
    obs, nobs, action, reward, not_terminal, mask = b
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(obs), next_state=rlt.FeatureData(nobs), action=action,
        next_action=action, reward=reward, time_diff=None, step=None,
        not_terminal=not_terminal, possible_actions_mask=torch.ones_like(mask),
        possible_next_actions_mask=mask).to(device)


def states_equal(torch, a, b, label):
    """Every tensor of two states bit for bit; the count."""
    from reagent_tpu_torch.utils.checkpointing import flatten_state

    fa, fb = flatten_state(a), flatten_state(b)
    if fa.keys() != fb.keys():
        raise AssertionError(f"{label}: the states hold other fields")
    for k, v in fb.items():
        if not torch.equal(fa[k], v):
            raise AssertionError(f"{label}: {k} parts by {(fa[k] - v).abs().max().item():.3e}")
    return len(fb)


def parallel_phase(torch, name):
    """Phase 62: the parallel package at world size 1 on NCCL (a one-rank
    group in a temporary file store, destroyed at the end): the DP step of
    DQNTrainer with the CPE heads at the full width, the MP step of the
    changing-arms SparseDQN on a 1 x 1 (data, model) mesh and EsWorker over
    the one-rank group, each equal bit for bit to its plain step; then
    measure_scaling_efficiency at world size 1, which measures no scaling."""
    import torch.distributed as dist

    from reagent_tpu_torch import parallel
    from reagent_tpu_torch.core.parameters import EvolutionParameters, RLParameters
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training import DQNTrainer
    from reagent_tpu_torch.training.gradient_free import EsWorker

    t0 = time.perf_counter()
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    reset_counts()
    try:
        mesh = parallel.make_mesh(device=DEVICE)

        def dqn():
            widths, acts = FULL["widths"], [FULL["act"]] * len(FULL["widths"])
            return FullyConnectedDQN(FULL["D"], FULL["A"], widths, acts)

        trainer = DQNTrainer(dqn(), rl=RLParameters(gamma=FULL["gamma"],
                                                    target_update_rate=FULL["tau"]),
                             optimizer={"Adam": {"lr": FULL["lr"]}}, reward_network=dqn(),
                             q_network_cpe=dqn(), device=DEVICE)
        first = trainer.init(torch.Generator().manual_seed(120))
        plain, dp = copy_state(first, DEVICE), parallel.replicate(first, mesh)
        step = parallel.make_data_parallel_train_step(trainer, mesh)
        for i in range(PARALLEL["steps"]):
            batch = full_width_dqn_batch(torch, 1200 + i, DEVICE)
            plain, m = trainer.train_step(plain, batch)
            dp, m_dp = step(dp, parallel.shard_batch(batch, mesh))
            for k, v in m.items():
                if not torch.equal(m_dp[k], v):
                    raise AssertionError(f"DP step {i}: metric {k} {m_dp[k]} against {v}")
        out["DP DQNTrainer with CPE heads, state tensors equal"] = states_equal(
            torch, dp, plain, "DP step")

        mesh2 = parallel.make_2d_mesh(device=DEVICE)
        arms, _ = sparse_arms_trainer(torch, DEVICE)
        first = arms.init(torch.Generator().manual_seed(121))
        plain, mp = copy_state(first, DEVICE), parallel.shard_state(first, mesh2)
        step = parallel.make_model_parallel_train_step(arms, mesh2)
        rng = np.random.default_rng(122)
        for i in range(PARALLEL["steps"]):
            batch = arms_batch(torch, arms_raw(rng), DEVICE)
            plain, m = arms.train_step(plain, batch)
            mp, m_mp = step(mp, parallel.shard_batch(batch, mesh2))
            for k, v in m.items():
                if not torch.equal(m_mp[k], v):
                    raise AssertionError(f"MP step {i}: metric {k} {m_mp[k]} against {v}")
        out["MP changing-arms SparseDQN, state tensors equal"] = states_equal(
            torch, mp, plain, "MP step")

        es = EvolutionParameters()
        local, grouped = EsWorker(one_max_pool(torch, DEVICE), es), EsWorker(
            one_max_pool(torch, DEVICE), es, mesh.groups["data"])
        for epoch in range(ES_SLICE["epochs"]):
            a = local.run_epoch(local.pool.compute_local_reward, epoch)
            b = grouped.run_epoch(grouped.pool.compute_local_reward, epoch)
            if a != b:
                raise AssertionError(f"EsWorker epoch {epoch}: {b} against the local {a}")
        if not torch.equal(local.pool.parent_tensors["data"], grouped.pool.parent_tensors["data"]):
            raise AssertionError("EsWorker: the parents part")
        out["EsWorker over the one-rank group, mean reward"] = b
        log(f"  world size 1 on NCCL: DP step of DQNTrainer with the CPE heads (B {FULL['B']}), "
            f"MP step of the changing-arms SparseDQN and {ES_SLICE['epochs']} EsWorker epochs "
            f"equal bit for bit to the plain steps ({json.dumps(out)})")

        sweep_trainer = DQNTrainer(dqn(), rl=RLParameters(gamma=FULL["gamma"],
                                                          target_update_rate=FULL["tau"]),
                                   optimizer={"Adam": {"lr": FULL["lr"]}}, device=DEVICE)
        sweep = parallel.measure_scaling_efficiency(
            sweep_trainer, sweep_trainer.init(torch.Generator().manual_seed(123)),
            lambda n: full_width_dqn_batch(torch, 1300, DEVICE), device_counts=[1],
            num_steps=PARALLEL["scaling_steps"], device=DEVICE)
        out["measure_scaling_efficiency"] = {str(k): v for k, v in sweep.items()}
        log(f"  measure_scaling_efficiency at world size 1 (DQNTrainer, B {FULL['B']}): "
            f"{json.dumps(out['measure_scaling_efficiency'])}; one card measures no scaling")
    finally:
        dist.destroy_process_group()
    launches, plain_calls = read_counts()
    if any(launches.values()) or plain_calls:
        raise AssertionError(f"phase 62: launches {launches}, plain calls {plain_calls}")
    log(f"  [{time.perf_counter() - t0:.1f} s into the phase] on {card_line()}")
    return out


# ------------------------------------------------------ the leaf utilities

# BayesianByBackpropOptimizer at its defaults (batch 512, so max(4 x 512,
# 50) = 2,048 candidates a step, hidden 32, 50 train steps an update) over
# 16 parameters of 8 choices each: a 128-wide one-hot, K3 at [2048,
# 128->32->1] relu
LITE = dict(params=16, choices=8, batch=512, lockstep_steps=10, bbb_steps=3, timed_steps=4,
            profiled=1, frechet=(1024, 20), numpy_batch=128, numpy_steps=2)
LITE_TOL = dict(logits=dict(rtol=1e-5, atol=1e-6), param=dict(rtol=5e-4, atol=5e-5),
                k3=dict(rtol=1e-5, atol=1e-5), log_prob=dict(rtol=1e-5, atol=1e-6))
NEAR_TIE = 1e-5  # of max(1, |prediction|): two candidates this close may sort either way
# grid_search through K2: two learning rates x two seeds, each evaluation
# 100 updates of the CartPole sample config from one numpy table
HPARAM = dict(lrs=(1e-3, 1e-2), seeds=2, updates=100, rows=8192, timed_updates=20)
NATIVE_ROWS = 64
K2_KERNEL = "k2_one_launch_kernel"  # K2's CUDA kernel, as the trace names it
NATIVE_TOL = 1e-4  # of max(1, |Q|): the artifact row of PERF.md's section 2


def lite_space():
    return {f"p{i}": list(range(LITE["choices"])) for i in range(LITE["params"])}


def lite_objectives(torch, device):
    """A cost on the sampled indices, the sum of one normal weight per
    (parameter, choice), so that distinct solutions cost distinct amounts,
    and the same cost on relaxed one-hots."""
    w = torch.tensor(np.random.default_rng(5).normal(
        size=(LITE["params"], LITE["choices"])).astype(np.float32), device=device)

    def cost(s):
        return sum(w[i][s[f"p{i}"]] for i in range(LITE["params"])).reshape(-1, 1)

    def soft_cost(s):
        return sum(s[f"p{i}"] @ w[i] for i in range(LITE["params"])).reshape(-1, 1)

    return cost, soft_cost


def lite_draws(torch, kind, space, bs, seed):
    """One step's draws on the CPU: Gumbel for policy gradient, uniforms in
    [1e-20, 1) for Gumbel-softmax."""
    from reagent_tpu_torch.mab.mab_algorithm import gumbel

    g = torch.Generator().manual_seed(seed)
    if kind == "gumbel":
        return {k: gumbel((bs, len(v)), g, "cpu") for k, v in space.items()}
    return {k: torch.rand((bs, len(v)), generator=g).clamp(min=1e-20) for k, v in space.items()}


def on(tree, device):
    return {k: v.to(device) for k, v in tree.items()}


def bbb_optimizer(torch, device, obj):
    from reagent_tpu_torch.lite import BayesianByBackpropOptimizer

    return BayesianByBackpropOptimizer(lite_space(), obj, batch_size=LITE["batch"], seed=0,
                                       device=device)


def solution_rows(sampled):
    """The sampled solutions (tensors or arrays) as sorted rows (a multiset
    of solutions)."""
    cols = np.stack([v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
                     for _, v in sorted(sampled.items())], axis=1)
    return cols[np.lexsort(cols.T[::-1])]


def bbb_lockstep(torch, opts, worst):
    """``LITE['bbb_steps']`` optimize steps of Bayes by backprop on both
    devices from one init with the same noise (drawn on the CPU): the
    candidates' predictions (K3 on the card, the plain version on the CPU),
    the chosen solutions, their costs, and the surrogate's parameters after
    each update.  The chosen solutions are the same multiset unless the
    predictions of every candidate that one device chose and the other did
    not are within NEAR_TIE of max(1, |prediction at the cut|): then the card
    takes the CPU's chosen set and the runs go on in step.  Every step is
    compared, and every step after the first ranks candidates."""
    preds, chosen = {}, {}
    cpu, card = opts["cpu"], opts[DEVICE]
    for d, opt in opts.items():
        fwd = opt.net.forward

        def recording(params, x, noise, fwd=fwd, d=d):
            preds[d] = fwd(params, x, noise).cpu().numpy()
            return preds[d]
        opt.net.forward = recording
    cpu_sample, card_sample = cpu.sample_internal, card.sample_internal

    def cpu_recording(batch_size=None, draws=None):
        res = cpu_sample(batch_size, draws)
        chosen["cpu"] = {k: v.numpy().copy() for k, v in res[0].items()}
        return res

    def card_following(batch_size=None, draws=None):
        (sampled,) = card_sample(batch_size, draws)
        if np.array_equal(solution_rows(sampled), solution_rows(chosen["cpu"])):
            return (sampled,)
        if not card.xs:
            raise AssertionError("BBB: the first samples differ")
        pc, pd, bs = preds["cpu"], preds[DEVICE], LITE["batch"]
        cut = float(np.sort(pc)[bs - 1])
        parted = np.setxor1d(np.argsort(pc)[:bs], np.argsort(pd)[:bs])
        gap = float(np.abs(pc[parted] - cut).max())
        if gap > NEAR_TIE * max(1.0, abs(cut)):
            raise AssertionError(f"BBB: the chosen solutions differ; a candidate that only one "
                                 f"device chose lies {gap:.3e} from the cut, not a near-tie")
        log(f"  BBB: a near-tie at the cut ({len(parted)} candidates within {gap:.3e}); the "
            f"card takes the CPU's chosen set")
        worst["BBB near-ties followed"] = worst.get("BBB near-ties followed", 0) + 1
        sampled = card._upload(chosen["cpu"])
        card.last_sample_internal_res = (sampled,)
        return (sampled,)
    cpu.sample_internal, card.sample_internal = cpu_recording, card_following

    g = torch.Generator().manual_seed(77)
    steps = ranked = 0
    for _ in range(LITE["bbb_steps"]):
        sampling = bool(cpu.xs)
        sample = cpu.net.draw_noise(g) if sampling else None
        update = [cpu.net.draw_noise(g) for _ in range(cpu.train_steps)]
        preds.clear()
        out = {d: opt.optimize_step(
            sample_draws=None if sample is None else on(sample, d),
            update_draws=[on(u, d) for u in update]) for d, opt in opts.items()}
        if sampling:
            pc, pd = preds["cpu"], preds[DEVICE]
            np.testing.assert_allclose(pd, pc, **LITE_TOL["k3"])
            worst["BBB predictions"] = max(worst.get("BBB predictions", 0.0),
                                           float(np.abs(pd - pc).max()))
            ranked += 1
        if not np.array_equal(solution_rows(out[DEVICE][0]), solution_rows(out["cpu"][0])):
            raise AssertionError("BBB: the chosen solutions differ")
        np.testing.assert_allclose(np.sort(out[DEVICE][1]), np.sort(out["cpu"][1]), rtol=1e-6)
        for k, v in cpu.net.params.items():
            got = card.net.params[k]
            worst["BBB parameters"] = max(worst.get("BBB parameters", 0.0),
                                          mb_close(torch, got, v, LITE_TOL["param"], f"BBB {k}"))
        worst["BBB loss"] = max(worst.get("BBB loss", 0.0), abs(
            card.last_predictor_loss_mean - cpu.last_predictor_loss_mean))
        steps += 1
    if steps != LITE["bbb_steps"] or ranked != LITE["bbb_steps"] - 1:
        raise AssertionError(f"BBB: {steps} steps compared, {ranked} rankings")
    worst["BBB steps compared"] = steps
    return worst


def lite_card_cpu_phase(torch):
    """Phase 63: the lite optimizers and Frechet sort card against CPU from
    one state and one set of draws: random search, Q-learning and the
    MLP ensemble (numpy streams; the objective on each device) 2 steps of
    128,
    policy gradient and Gumbel-softmax 10 steps on the same Gumbel draws and
    uniforms (samples equal, logits rtol 1e-5), Bayes by backprop 3 steps at
    its defaults (the surrogate's parameters rtol 5e-4 atol 5e-5), then
    FrechetSort at [1,024, 20] on the same Gumbel draws (the same
    permutations, log-probs rtol 1e-5)."""
    from reagent_tpu_torch import lite
    from reagent_tpu_torch.samplers import FrechetSort

    t0 = time.perf_counter()
    space, bs = lite_space(), LITE["batch"]
    objs = {d: lite_objectives(torch, d) for d in ("cpu", DEVICE)}
    worst = {}
    for cls in (lite.RandomSearchOptimizer, lite.QLearningOptimizer,
                lite.BayesianMLPEnsemblerOptimizer):
        # numpy streams: the objective is what runs on each device
        opts = {d: cls(space, objs[d][0], batch_size=LITE["numpy_batch"], seed=3, device=d)
                for d in objs}
        for _ in range(LITE["numpy_steps"]):
            out = {d: opt.optimize_step() for d, opt in opts.items()}
            for k, v in out["cpu"][0].items():
                if not torch.equal(out[DEVICE][0][k].cpu(), v):
                    raise AssertionError(f"{cls.__name__}: samples of {k} differ")
            np.testing.assert_allclose(out[DEVICE][1], out["cpu"][1], rtol=1e-6)
        if opts[DEVICE].best_solutions(50) != opts["cpu"].best_solutions(50):
            raise AssertionError(f"{cls.__name__}: best solutions differ")
    for cls, kind, obj_i in ((lite.PolicyGradientOptimizer, "gumbel", 0),
                             (lite.GumbelSoftmaxOptimizer, "uniform", 1)):
        opts = {d: cls(space, objs[d][obj_i], batch_size=bs, learning_rate=0.1, seed=4,
                       device=d) for d in objs}
        for step in range(LITE["lockstep_steps"]):
            draws = lite_draws(torch, kind, space, bs, 600 + step)
            out = {d: opt.optimize_step(sample_draws=on(draws, d)) for d, opt in opts.items()}
            for k, v in out["cpu"][0].items():
                if not torch.equal(out[DEVICE][0][k].cpu(), v):
                    raise AssertionError(f"{cls.__name__}: samples of {k} differ at step {step}")
        worst[cls.__name__] = max(
            mb_close(torch, opts[DEVICE].logits[k], v, LITE_TOL["logits"], f"{cls.__name__} {k}")
            for k, v in opts["cpu"].logits.items())
    bbb_lockstep(torch, {d: bbb_optimizer(torch, d, objs[d][0]) for d in objs}, worst)

    B, N = LITE["frechet"]
    g = np.random.default_rng(8)
    scores = torch.tensor(g.uniform(0.05, 2.0, (B, N)).astype(np.float32))
    noise = torch.tensor(g.gumbel(size=(B, N)).astype(np.float32))
    for kw in ({}, {"topk": 10, "equiv_len": 5}):
        sampler = FrechetSort(shape=2.0, **kw)
        cpu = sampler.sample_action(scores, noise=noise)
        card = sampler.sample_action(scores.to(DEVICE), noise=noise.to(DEVICE))
        if not torch.equal(card.action.cpu(), cpu.action):
            raise AssertionError(f"FrechetSort {kw}: the permutations differ")
        worst[f"FrechetSort {kw or 'full'} log_prob"] = mb_close(
            torch, card.log_prob, cpu.log_prob, LITE_TOL["log_prob"], "FrechetSort log_prob")
    log(f"  card against CPU, max abs: {json.dumps(worst)}")
    log(f"  [{time.perf_counter() - t0:.1f} s into the phase] on {card_line()}")
    return worst


def hparam_table(torch):
    """The CartPole sample config's DQN columns (4 features, 2 actions),
    drawn from numpy.random.default_rng(0), on the card."""
    n, S, A = HPARAM["rows"], CARTPOLE["D"], CARTPOLE["A"]
    g = np.random.default_rng(0)
    put = lambda a: torch.tensor(a, device=DEVICE)
    return dict(state=put(g.normal(size=(n, S)).astype(np.float32)),
                next_state=put(g.normal(size=(n, S)).astype(np.float32)),
                action=put(np.eye(A, dtype=np.float32)[g.integers(0, A, n)]),
                reward=put(g.normal(size=(n, 1)).astype(np.float32)),
                not_terminal=put((g.random((n, 1)) > 0.05).astype(np.float32)),
                mask=put(np.ones((n, A), np.float32)))


def k2_batch(torch, table, idx):
    """The table's rows ``idx`` as a minibatch."""
    from reagent_tpu_torch.core import types as rlt

    t = {k: v[idx] for k, v in table.items()}
    return rlt.DiscreteDqnInput(
        state=rlt.FeatureData(t["state"]), next_state=rlt.FeatureData(t["next_state"]),
        action=t["action"], next_action=t["action"], reward=t["reward"], time_diff=None,
        step=None, not_terminal=t["not_terminal"], possible_actions_mask=t["mask"],
        possible_next_actions_mask=t["mask"])


def k2_trainer(torch, lr, seed):
    """The CartPole sample config's fused trainer (K2) with ``lr``."""
    from reagent_tpu_torch.core.parameters import RLParameters
    from reagent_tpu_torch.models.dqn import FullyConnectedDQN
    from reagent_tpu_torch.training.fused_dqn_trainer import FusedDQNTrainer

    cfg = CARTPOLE
    net = FullyConnectedDQN(state_dim=cfg["D"], action_dim=cfg["A"], sizes=cfg["widths"],
                            activations=[cfg["act"]] * len(cfg["widths"]))
    trainer = FusedDQNTrainer(
        q_network=net, rl=RLParameters(gamma=cfg["gamma"], target_update_rate=cfg["tau"]),
        optimizer={"Adam": {"lr": lr}}, minibatch_size=cfg["B"], device=DEVICE)
    return trainer, trainer.init(torch.Generator().manual_seed(seed))


def k2_updates(torch, table, trainer, state, seed, n):
    """``n`` K2 updates on minibatches of ``table`` drawn with
    numpy.random.default_rng(seed); the last metrics."""
    idx = torch.tensor(np.random.default_rng(seed).integers(
        0, HPARAM["rows"], (n, CARTPOLE["B"])), device=DEVICE)
    metrics = None
    for i in range(n):
        state, metrics = trainer.train_step(state, k2_batch(torch, table, idx[i]))
    return state, metrics


def leaf_timed_phase(torch, name, launch_floor_ms):
    """Phase 64: K3 at the surrogate's [2048, 128->32->1] relu against its
    plain version, timed beside one torch.addmm a layer and its bound; 5
    optimize steps of BayesianByBackpropOptimizer at its defaults after a
    warm one (one K3 launch each; ms a step, CUDA kernels, idle share, host
    reads and Memcpy DtoH from a profiled window); StepTimer over K2 updates and a
    trace (utils/profiling.py) whose Chrome trace names the K2 kernel; then
    grid_search over two learning rates x two seeds, each evaluation 100 K2
    updates of the CartPole sample config, objective the final td_loss."""
    from reagent_tpu_torch.lite import MLPBayesianByBackprop
    from reagent_tpu_torch.ops import fused_dqn
    from reagent_tpu_torch.scripts.hparam_tuning import grid_search
    from reagent_tpu_torch.utils.profiling import StepTimer, annotate, trace

    t0 = time.perf_counter()
    out = {"k3": {}}
    obj, _ = lite_objectives(torch, DEVICE)
    opt = bbb_optimizer(torch, DEVICE, obj)
    opt.optimize_step()  # the first step has no data: no surrogate forward
    # the surrogate's forward at the step's shape, on its sampled weights
    rows = max(4 * LITE["batch"], opt.num_mutations)
    x = torch.as_tensor(opt._encode(opt._mutate(rows)), dtype=torch.float32, device=DEVICE)
    weights = MLPBayesianByBackprop.sampled_weights(opt.net.params,
                                                    opt.net.draw_noise(opt.generator))
    label = f"Bayes-by-backprop surrogate [{rows}, {opt.dim}->32->1]"
    out["k3"][label] = k3_row(torch, name, label, x, weights,
                              list(MLPBayesianByBackprop.ACTIVATIONS), launch_floor_ms,
                              sleep_cycles=200_000_000)

    reset_counts()
    wall_ms, dev, kernels, reads, copies = timed_steps(
        torch, opt.optimize_step, LITE["timed_steps"],
        f"BayesianByBackpropOptimizer step ({opt.dim}-wide one-hot, {rows} candidates, "
        f"batch {LITE['batch']}, {opt.train_steps} train steps)", LITE["profiled"])
    launches, plain = read_counts()
    calls = LITE["timed_steps"] + LITE["profiled"]
    if launches["fused_mlp_forward"] != calls or plain or sum(launches.values()) != calls:
        raise AssertionError(f"BBB steps: launches {launches}, plain calls {plain}")
    out["k3"][label]["launches_a_call"] = 1
    out["k3"][label]["launches"] = calls
    out["BayesianByBackpropOptimizer"] = dict(
        ms_a_step=wall_ms, device_us_a_step=dev, kernels_a_step=kernels,
        idle=1 - dev / (wall_ms * 1e3), host_reads=reads, memcpy_dtoh=copies,
        last_predictor_loss_mean=opt.last_predictor_loss_mean,
        best_cost=opt.best_solutions(1)[0][0])

    table = hparam_table(torch)
    trainer, state = k2_trainer(torch, CARTPOLE["lr"], 0)
    timer, box = StepTimer(), {}
    idx = torch.tensor(np.random.default_rng(1).integers(0, HPARAM["rows"], (
        HPARAM["timed_updates"], CARTPOLE["B"])), device=DEVICE)
    reset_counts()
    for i in range(HPARAM["timed_updates"]):
        with timer.measure(box):
            state, box["metrics"] = trainer.train_step(state, k2_batch(torch, table, idx[i]))
    with tempfile.TemporaryDirectory() as tdir:
        with trace(tdir):
            for i in range(3):
                with annotate("k2_update"):
                    state, _ = trainer.train_step(state, k2_batch(torch, table, idx[i]))
        text = open(os.path.join(tdir, "trace.json")).read()
    timer_launches, plain = read_counts()
    if K2_KERNEL not in text or '"k2_update"' not in text:
        raise AssertionError("the trace names neither the K2 kernel nor the annotated region")
    if timer_launches["fused_dqn_update"] != HPARAM["timed_updates"] + 3 or plain:
        raise AssertionError(f"StepTimer and trace: launches {timer_launches}, plain {plain}")
    out["StepTimer (K2 updates)"] = timer.summary()
    log(f"  StepTimer over {HPARAM['timed_updates']} K2 updates (CartPole sample config): "
        f"{json.dumps(out['StepTimer (K2 updates)'])}; the trace holds k2_one_launch_kernel "
        f"and the k2_update region")

    def eval_fn(p):
        trainer, state = k2_trainer(torch, p["lr"], p["seed"])
        _, metrics = k2_updates(torch, table, trainer, state, p["seed"], HPARAM["updates"])
        return {"td_loss": float(metrics["td_loss"])}

    reset_counts()
    t1 = time.perf_counter()
    best, best_metrics = grid_search({"lr": list(HPARAM["lrs"])}, eval_fn, "td_loss",
                                     num_seeds=HPARAM["seeds"], minimize=True, num_proc=1)
    grid_s = time.perf_counter() - t1
    grid_launches, plain = read_counts()
    evaluations = len(HPARAM["lrs"]) * HPARAM["seeds"]
    if (grid_launches["fused_dqn_update"] != evaluations * HPARAM["updates"] or plain
            or sum(grid_launches.values()) != grid_launches["fused_dqn_update"]):
        raise AssertionError(f"grid search: launches {grid_launches}, plain calls {plain}")
    if not np.isfinite(best_metrics["td_loss"][0]):
        raise AssertionError(f"grid search: td_loss {best_metrics}")
    out["grid_search"] = dict(best=best, td_loss=best_metrics["td_loss"], seconds=grid_s,
                              evaluations=evaluations)
    out["k2_launches"] = {"StepTimer and trace": timer_launches["fused_dqn_update"],
                          "grid_search": grid_launches["fused_dqn_update"]}
    log(f"  grid_search over lr {list(HPARAM['lrs'])} x {HPARAM['seeds']} seeds "
        f"({evaluations} x {HPARAM['updates']} K2 updates): best {best}, td_loss "
        f"{best_metrics['td_loss']}, {grid_s:.2f} s")
    log(f"  BayesianByBackpropOptimizer: {json.dumps(out['BayesianByBackpropOptimizer'])}")
    log(f"  [{time.perf_counter() - t0:.1f} s into the phase] on {card_line()}")
    return out


def keep_artifact(out, df, serving, keep, label):
    """Copy the workflow's artifact into ``keep`` (it outlives the phase's
    temporary directory) with its first rows and the in-process module."""
    import shutil

    path = os.path.join(keep, label)
    shutil.copytree(out.output_paths["default_model"], path)
    return dict(path=path, rows=df["state_features"].tolist()[:NATIVE_ROWS], serving=serving)


def native_serving_phase(torch, artifacts, binary):
    """Phase 65: the C++ decision service, ``binary`` (built from serving/
    into reagent_tpu_torch/_build/serving/ in phase 2), serves one plan
    per kept artifact (root ActionValueScoring, every action chosen,
    authored with the port's DSL): every action's native Q on 64 raw rows
    within 1e-4 of max(1, |Q|) of the in-process serving module on the
    card."""
    from reagent_tpu_torch.preprocessing.batch_preprocessor import sparse_to_dense
    from reagent_tpu_torch.serving import (
        ActionValueScoring,
        DecisionPlanBuilder,
        export_plan,
        native,
    )

    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as plans:
        for label, a in artifacts.items():
            n_actions = a["serving"].model.q_network.action_dim
            export_plan(DecisionPlanBuilder().set_root(ActionValueScoring(model_path=a["path"]))
                        .set_num_actions_to_choose(n_actions), os.path.join(plans, f"{label}.json"))
        with native.decision_service(plans, binary=binary) as client:
            for label, a in artifacts.items():
                sf = a["serving"].model.preprocessor.sorted_features
                values, presence = sparse_to_dense(a["rows"], sf)
                names, q_live = a["serving"](torch.tensor(values, device=DEVICE),
                                             torch.tensor(presence, device=DEVICE))
                q_live = q_live.cpu().numpy().astype(np.float64)
                t1 = time.perf_counter()
                q_native = native.action_values(client, label, names, a["rows"])
                ms = (time.perf_counter() - t1) / len(a["rows"]) * 1e3
                scaled = np.abs(q_native - q_live) / np.maximum(1.0, np.abs(q_live))
                if q_native.shape != q_live.shape or not (scaled <= NATIVE_TOL).all():
                    raise AssertionError(f"{label}: native Q parts from the in-process module "
                                         f"by {scaled.max():.3e} of max(1, |Q|)")
                out[label] = dict(rows=len(a["rows"]), actions=len(names),
                                  max_abs=float(np.abs(q_native - q_live).max()),
                                  max_scaled=float(scaled.max()), ms_a_request=ms)
                log(f"  {label} artifact ({len(names)} actions): native Q of {len(a['rows'])} raw "
                    f"rows against the in-process module on the card: max abs "
                    f"{out[label]['max_abs']:.3e}, {out[label]['max_scaled']:.3e} of max(1, |Q|); "
                    f"{ms:.3f} ms a request (HTTP on localhost)")
    log(f"  [{time.perf_counter() - t0:.1f} s into the phase]")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from concurrent.futures import ThreadPoolExecutor

    from reagent_tpu_torch.ops import _build, fused_dqn, fused_dqn_offline  # noqa: F401
    from reagent_tpu_torch.serving import native

    # Comparisons and timings in full float32: no TF32 in the plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("phase 1: device")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, {torch.cuda.device_count()} card(s)")

    phase("phase 2: build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        # g++ of the C++ decision service (phase 65) beside the nvcc builds,
        # finished before any timed window
        service_build = pool.submit(native.build_decision_service)
        libs = _build.build_all()
        service = service_build.result()
    for lib in ("fused_dqn", "fused_mlp", "nstep_replay", "quantile_huber"):
        _build.load_library(lib)
    build_s = time.perf_counter() - t0
    log(f"  built {[os.path.basename(p) for p in libs]} and {os.path.relpath(service)} "
        f"(g++) in {build_s:.2f} s")

    phase("phase 3: K1 against its plain version (full width; B=4096, and the DQN "
          "benchmark cell's B=16384)")
    err_k1 = compare_kernel("K1", FULL, torch, LAUNCH_SEQUENCE)
    routes = fused_dqn_offline.product_routes()
    err_k1_cell = compare_kernel("K1 B=16384", K1_CELL, torch, LAUNCH_SEQUENCE)
    after = fused_dqn_offline.product_routes()
    log(f"  products by tile route, K1 at B=16384 (10 updates): "
        f"{ {k: after[k] - routes[k] for k in after if after[k] != routes[k]} }")
    phase("phase 4: K2 against its plain version: one launch at the CartPole sample shapes, "
        "the launch sequence at the full offline width")
    err_k2 = compare_kernel("K2", CARTPOLE, torch, ONE_LAUNCH)
    err_k2_seq = compare_kernel("K2 (launch sequence)", K2_LARGE, torch, LAUNCH_SEQUENCE)

    phase("phase 5: timing (CUDA events, 3 warm-ups, median of 20)")
    timing = {}
    for kname, cfg in (("K1", FULL), ("K2", CARTPOLE), ("K2 (launch sequence)", K2_LARGE)):
        timing[kname] = time_kernel(cfg, torch, name)
        ms, plain_ms, b_ms, b_by, flops, nbytes = timing[kname]
        log(f"  {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {flops:.4g} FLOP, {nbytes:.4g} B), "
            f"{b_ms / ms * 100:.1f}% of the bound, on {card}")
    products = {"K1": products_library_ms(FULL, torch)}
    log(f"  K1's products through torch.matmul (cuBLAS, f32, no TF32; a yardstick only): "
        f"{products['K1']:.4f} ms, on {card}")
    gemm_us = {}
    for kname, cfg in (("K1", FULL), ("K2", CARTPOLE)):
        log(f"  {kname} device time by CUDA kernel (torch.profiler, mean of 5 updates):")
        gemm_us[kname] = profile_update(cfg, torch)[1]

    # phases 6 and 7's artifacts, kept for the C++ service of phase 65
    kept_dir = tempfile.TemporaryDirectory()
    kept = {}
    with tempfile.TemporaryDirectory() as tmp:
        phase("phase 6: workflow at full width through K1")
        k1_launches, k1_steps, _ = workflow_phase(
            FULL, FULL_ROWS, FULL_EPOCHS, "fused_dqn_offline_update", torch, tmp, "full_width",
            keep=(kept_dir.name, kept))
        phase("phase 7: workflow at the CartPole sample config's shapes through K2")
        k2_launches, _, _ = workflow_phase(
            CARTPOLE, 2048, 2, "fused_dqn_update", torch, tmp, "cartpole_sample",
            keep=(kept_dir.name, kept))

    phase("phase 8: K2's packed interface, K3 and K4 against their plain versions")
    err_k2p = compare_k2_packed(torch)
    err_k3 = compare_k3(torch)
    err_k4 = compare_k4(torch)

    phase("phase 9: timing of K2-packed, K3 and K4 (CUDA events, 3 warm-ups, median of 20)")
    online_timing = time_online_kernels(torch, name)
    for kname, (ms, plain_ms, b_ms, b_by, flops, nbytes, shapes) in online_timing.items():
        log(f"  {kname} ({shapes}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}; {flops:.4g} FLOP, {nbytes:.4g} B), on {card}")
    kern_t, _, kw_t = kernel_fns(CARTPOLE, True)
    _, batch_t, params_t = make_inputs(CARTPOLE, 98, torch, DEVICE)
    lr_t, eps_t = step_scalars(torch, 0, CARTPOLE["lr"], DEVICE)
    host_us = {"K2-packed": host_us_per_call(torch, k2_packed_call(torch)[0]),
               "K2": host_us_per_call(torch, lambda: kern_t(lr_t, eps_t, *batch_t, params_t, **kw_t))}
    log(f"  K2 wrapper host time per call (time.perf_counter over 200 calls, no sync): "
        f"packed {host_us['K2-packed']:.1f} us, tensor {host_us['K2']:.1f} us, "
        f"{fused_dqn.fused_dqn_update_packed.kernels_per_update} CUDA kernel per update")
    host_us.update(online_host_us(torch))
    launch_floor_ms = time_ms(torch, lambda: torch.cuda._sleep(0))
    k3_addmm_ms = k3_products_library_ms(torch)
    log(f"  K3 wrapper host time per call: [1, 4] {host_us['K3 [1, 4]']:.1f} us, [20, 4] "
        f"{host_us['K3 [20, 4]']:.1f} us; K4 (loop shape) {host_us['K4 loop']:.1f} us; "
        f"queued launch floor (an empty kernel, CUDA events) {launch_floor_ms:.4f} ms; "
        f"K3 [1, 4] as one torch.addmm per layer (a yardstick only) {k3_addmm_ms:.4f} ms, "
        f"on {card}")
    log("  K2-packed device time by CUDA kernel (torch.profiler, mean of 5 updates):")
    profile_calls(torch, k2_packed_call(torch)[0])

    phase(f"phase 10: fused online loop at the bench's width ({FUSED_STEPS} steps)")
    fused_launches, fused_rate, _ = fused_loop_phase(torch, FUSED_STEPS)

    phase(f"phase 11: generic online loop ({GENERIC_STEPS} steps) and evaluate_policy")
    generic_launches, eval_launches, _ = generic_loop_phase(torch, GENERIC_STEPS)

    phase("phase 12: K5 (quantile-Huber loss: two forward routes and the backward) against "
        "its plain versions")
    err_k5, err_k5_grad, err_k5_scale = compare_k5(torch)

    phase("phase 13: timing of K5 (CUDA events, 3 warm-ups, median of 20)")
    k5_timing = time_k5(torch, name)
    for (kB, kN), t in k5_timing.items():
        parts = []
        for key, label in (("loss", "loss-only forward"), ("sums", "forward with sums"),
                           ("bwd", "backward"), ("pair", "trainer's pair")):
            b_ms, b_by = t["bounds"][key]
            parts.append(f"{label} {t[key]:.4f} ms (plain {t['plain_' + key]:.4f}, bound "
                         f"{b_ms:.6f}, {b_by})")
        log(f"  K5 [{kB}, {kN}] ({t['pairs']:.4g} pairs; {K5_LOSS_INSTR} and {K5_SUMS_INSTR} "
            f"instructions a pair): " + "; ".join(parts) + f", on {card}")
    k5_main = k5_timing[K5_SHAPES[0]]

    phase("phase 14: offline QR-DQN workflow at full width through K5")
    with tempfile.TemporaryDirectory() as tmp:
        qr_launches, _, _ = qr_workflow_phase(torch, tmp, k5_main["pair"])

    phase("phase 15: QR-DQN train steps, card against CPU")
    qr_lockstep_phase(torch)

    phase(f"phase 16: online QR-DQN loop ({QR_ONLINE['steps']} steps) and evaluate_policy")
    qr_online_launches, _ = qr_online_phase(torch)

    bf16, f32 = torch.bfloat16, torch.float32
    phase("phase 17: K1 with its bfloat16 options against its plain version (full width)")
    err_k1_bf16 = compare_k1_bf16(torch, (bf16, bf16), "K1-bf16 (matmul bf16, save bf16)")
    err_k1_save = compare_k1_bf16(torch, (f32, bf16), "K1 (matmul f32, save bf16)")

    phase("phase 18: timing of K1-bf16 (CUDA events, 3 warm-ups, median of 20)")
    timing["K1-bf16"] = time_kernel(FULL, torch, name, (bf16, bf16))
    timing["K1 again"] = time_kernel(FULL, torch, name)
    for kname in ("K1-bf16", "K1 again"):
        ms, plain_ms, b_ms, b_by, flops, nbytes = timing[kname]
        log(f"  {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}; {flops:.4g} FLOP, {nbytes:.4g} B), {b_ms / ms * 100:.1f}% of the "
            f"bound, on {card}")
    products["K1-bf16"] = products_library_ms(FULL, torch, bf16_products=True)
    log(f"  K1-bf16's products through torch.matmul (cuBLAS, bf16 operands; a yardstick only): "
        f"{products['K1-bf16']:.4f} ms, on {card}")
    log("  K1-bf16 device time by CUDA kernel (torch.profiler, mean of 5 updates):")
    gemm_us["K1-bf16"] = profile_update(FULL, torch, dtypes=(bf16, bf16))[1]

    phase(f"phase 19: device-resident fused loop ({TABLE_ROWS} rows on the card, minibatch "
        f"{FULL['B']}, block {SCAN_BLOCK})")
    dataset = offline_dataset(torch, DEVICE)
    trainer_bf16, state_bf16, scan_bf16, rates_bf16, td_bf16 = device_resident_fused_phase(
        torch, dataset, bf16, "fused loop, matmul bf16")
    _, _, scan_f32, rates_f32, td_f32 = device_resident_fused_phase(
        torch, dataset, f32, "fused loop, f32 twin")
    fused_lockstep_against_cpu(torch, dataset)
    k3_scan_launches = q_values_phase(torch, trainer_bf16, state_bf16, dataset)

    phase(f"phase 20: unfused scan path (DQNTrainer, {UNFUSED_STEPS} steps each)")
    unfused = {label: unfused_scan_phase(torch, dataset, dtype, f"unfused scan, {label}")
               for label, dtype in (("compute f32", None), ("compute bf16", bf16))}
    compare_td_paths(torch, {"fused f32": td_f32, "fused bf16": td_bf16,
                             **{f"unfused {k}": v[1] for k, v in unfused.items()}})
    log("  steps/s on " + card + ": fused bf16 "
        + ", ".join(f"{r:.2f} ({n})" for n, r in rates_bf16.items()) + "; fused f32 "
        + ", ".join(f"{r:.2f} ({n})" for n, r in rates_f32.items()) + "; "
        + "; ".join(f"{k} {v[0]:.2f}" for k, v in unfused.items()))
    del dataset

    phase("phase 21: K3 at the evaluation's shapes against its plain version, timed")
    k3_eval = k3_shapes_phase(torch, name, K3_EVAL_SHAPES, K3_EVAL_SHAPES, launch_floor_ms)

    with tempfile.TemporaryDirectory() as tmp:
        phase("phase 22: the flagship sample config unchanged (CPE on) through "
              "identify_and_train_network")
        sample_cfg = dict(CARTPOLE, B=SAMPLE_CONFIG["model"]["DiscreteDQN"]["trainer_param"][
            "minibatch_size"])
        split = (SAMPLE_CONFIG["table_sample"], SAMPLE_CONFIG["eval_table_sample"])
        cpe_sample = cpe_workflow_phase(
            torch, tmp, "cpe_sample_config", sample_cfg, SAMPLE_CONFIG["model"],
            SAMPLE_CPE_ROWS, SAMPLE_CONFIG["num_epochs"], split)
        phase("phase 23: the full offline width with CPE (unfused DQNTrainer, three heads)")
        cpe_full = cpe_workflow_phase(
            torch, tmp, "cpe_full_width", FULL, full_cpe_model(), FULL_CPE_ROWS,
            FULL_CPE_EPOCHS, split)

    phase("phase 24: CPE, card against CPU")
    cpe_trainer, cpe_state = cpe_lockstep_phase(torch)
    for label, run in (("sample config", cpe_sample), ("full width", cpe_full)):
        cpe_edp_against_cpu(torch, run, label)

    with tempfile.TemporaryDirectory() as tmp:
        phase("phase 25: the dqn_cartpole_e2e job (offline_gym_random, timeline_operator, "
              "identify_and_train_network with the reporter, evaluate_gym)")
        e2e = e2e_phase(torch, tmp)
        phase("phase 26: warm start and reward options at full width through K1")
        warm = warm_start_phase(torch, tmp, cpe_trainer, cpe_state)

    phase("phase 27: SAC and TD3 train steps at the sample config's widths, card against CPU")
    ac_lockstep_phase(torch, "SAC", 5)
    ac_lockstep_phase(torch, "TD3", 4)

    with tempfile.TemporaryDirectory() as tmp:
        phase("phase 28: the sac_pendulum_e2e job through reagent run (offline_gym_random, "
              "timeline_operator, identify_and_train_network, evaluate_gym)")
        sac_job_phase(torch, tmp)

    phase("phase 29: discrete CRR train steps at the online config's widths, card against CPU")
    crr_lockstep_phase(torch)

    with tempfile.TemporaryDirectory() as tmp:
        phase(f"phase 30: the offline CRR job (offline_gym_random, timeline_operator, "
              f"identify_and_train_network with DiscreteCRR, {CRR_OFFLINE['epochs']} epochs, "
              "evaluate_gym)")
        crr_job = crr_offline_job_phase(torch, tmp, CRR_OFFLINE["epochs"])

    phase(f"phase 31: online discrete CRR through the generic loop ({CRR_ONLINE['steps']} "
          "steps) and evaluate_policy")
    crr_online = crr_online_phase(torch, CRR_ONLINE["steps"])

    phase("phase 32: REINFORCE and PPO on the functional CartPole: card against CPU, then "
          "the configs' runs")
    pg = {}
    for pg_name in PG_CONFIGS:
        pg_lockstep_phase(torch, pg_name)
    for pg_name, pg_cfg in PG_CONFIGS.items():
        pg[pg_name] = pg_run_phase(torch, pg_name, pg_cfg["episodes"])

    phase("phase 33: C51, parametric DQN and parametric SARSA train steps at the online "
          "configs' widths, card against CPU")
    for fam_name in DQN_FAMILY_ONLINE:
        dqn_family_lockstep_phase(torch, fam_name)

    phase("phase 34: K3 and K4 at the C51 and parametric paths' shapes against their plain "
          "versions, timed (CUDA events, 3 warm-ups, median of 20)")
    family_kernels = k3_k4_family_phase(torch, name, launch_floor_ms)

    phase("phase 35: online C51, parametric DQN and parametric SARSA through the generic loop "
          "and evaluate_policy")
    fam_online = {fam_name: dqn_family_online_phase(torch, fam_name, cfg["steps"], cfg["prefill"])
                  for fam_name, cfg in DQN_FAMILY_ONLINE.items()}

    with tempfile.TemporaryDirectory() as tmp:
        phase("phase 36: the DiscreteC51DQN and ParametricDQN managers through "
              "identify_and_train_network")
        fam_offline = {fam_name: dqn_family_offline_phase(torch, tmp, fam_name, cfg["epochs"])
                       for fam_name, cfg in DQN_FAMILY_OFFLINE.items()}

    phase("phase 37: the optimizer union's other members and the LR schedulers, card against "
          "CPU at the full offline width's parameters")
    optimizers_phase(torch)

    phase("phase 38: FullyConnectedNetwork's options at the full offline width, card against "
          "CPU, and the offline DQN workflow with batch norm, dropout, RAdam and a cosine "
          "schedule")
    fcn_options_phase(torch)
    with tempfile.TemporaryDirectory() as tmp:
        options_workflow_phase(torch, tmp)

    phase("phase 39: online SAC, TD3 and continuous CRR train steps at the Pendulum jobs' "
          "widths, card against CPU")
    for cc_name in CONTINUOUS_JOBS:
        continuous_lockstep_phase(torch, cc_name)

    phase("phase 40: K3 at the continuous act and eval shapes, timed; the online Pendulum "
          f"jobs through the generic loop ({PRIORITIZED_JOB} on the prioritized buffer)")
    continuous_kernels = k3_shapes_phase(
        torch, name, K3_CONTINUOUS_SHAPES, K3_CONTINUOUS_TIMED, launch_floor_ms)
    cc_online = {cc_name: continuous_online_phase(
        torch, cc_name, cfg["steps"], cfg["prefill"], prioritized=cc_name == PRIORITIZED_JOB)
        for cc_name, cfg in CONTINUOUS_JOBS.items()}

    t_wm = time.perf_counter()
    phase("phase 41: the world-model slice's modules card against CPU: OpenGridworld and "
          "PossibleActionsMaskTester rollouts, MDN-RNN train steps, StateEmbedEnv")
    world_model_card_cpu_phase(torch)

    phase("phase 42: K3 and K4 at the world-model, gridworld and mask jobs' shapes, timed; the "
          "world-model string pipeline (MDN-RNN, StateEmbedEnv, online DQN) cut in depth")
    wm_k3 = k3_shapes_phase(torch, name, K3_WM_SHAPES, K3_WM_TIMED, launch_floor_ms)
    wm_k4 = {label: k4_shape_times(torch, name, label, shape, label in K4_WM_TIMED)
             for label, shape in K4_WM_SHAPES.items()}
    wm_k4 = {label: t for label, t in wm_k4.items() if t is not None}
    wm = world_model_phase(torch, WORLD_MODEL["wm_steps"], WORLD_MODEL["prefill"],
                           WORLD_MODEL["steps"], WORLD_MODEL["eval_episodes"])

    phase("phase 43: the OpenGridworld and possible-actions-mask DQN jobs cut in depth")
    grid = gridworld_phase(torch, GRIDWORLD_JOB["prefill"], GRIDWORLD_JOB["steps"],
                           GRIDWORLD_JOB["eval_episodes"])
    mask = mask_phase(torch, MASK_JOB["steps"], MASK_JOB["eval_episodes"])
    log(f"  phases 41-43 took {time.perf_counter() - t_wm:.1f} s together")

    t_sparse = time.perf_counter()
    phase("phase 44: the sparse slice's modules card against CPU: the changing-arms SparseDQN "
          "and its DQNTrainer, the touched-rows sparse embedding step")
    sparse_card_cpu_phase(torch)

    phase("phase 45: the sparse embedding step at bench.py's size (10,000,000 x 64, B 4,096, "
          "L 50)")
    sparse_scale = sparse_embedding_scale_phase(torch, name)

    phase("phase 46: K3 and K4 at the sparse changing-arms job's shapes, timed; the job cut in "
          "depth")
    sparse_k3 = k3_shapes_phase(torch, name, K3_SPARSE_SHAPES, K3_SPARSE_SHAPES, launch_floor_ms)
    sparse_k4 = {label: k4_shape_times(torch, name, label, shape)
                 for label, shape in K4_SPARSE_SHAPES.items()}
    arms = sparse_arms_phase(torch, SPARSE_ARMS_JOB["prefill"], SPARSE_ARMS_JOB["steps"],
                             SPARSE_ARMS_JOB["eval_episodes"])
    log(f"  phases 44-46 took {time.perf_counter() - t_sparse:.1f} s together")

    t_rank = time.perf_counter()
    phase("phase 47: the ranking slice's modules card against CPU: Seq2Slate at bench.py's _S2S "
          "width (greedy slates, log-probabilities, the cached decode, IPS steps) and slate-Q")
    ranking_card_cpu_phase(torch)

    phase("phase 48: Seq2Slate timed: IPS training at _S2S (B 256, f32) and _S2S_LARGE (B 1,024, "
          "bf16), greedy KV-cached ranking at B 512")
    s2s_timing = seq2slate_timed_phase(torch, name)

    phase("phase 49: K3 at the slate-Q act shape, timed; slate-Q on RecSim cut in depth, K3 on "
          "every act step")
    ranking = slate_q_recsim_phase(torch, name, launch_floor_ms)
    log(f"  phases 47-49 took {time.perf_counter() - t_rank:.1f} s together")

    t_mb = time.perf_counter()
    phase("phase 50: the model-based slice's modules card against CPU: Seq2Reward and the "
          "compress model, CEM, the synthetic-reward nets and trainer, the serving wrappers, "
          "the evaluators")
    mb_errors = model_based_card_cpu_phase(torch)

    phase("phase 51: K3 at the model-based serving shapes, timed; the CEM plans and the "
          "Seq2Reward steps timed")
    mb_timed = model_based_timed_phase(torch, name, launch_floor_ms)

    phase("phase 52: the CEM jobs (LinDyna with 1 and 2 world models, CartPole) and the "
          "Seq2Reward job cut in depth")
    mb_jobs = model_based_jobs_phase(torch, mb_timed.pop("corpus"))
    log(f"  phases 50-52 took {time.perf_counter() - t_mb:.1f} s together")

    t_cb = time.perf_counter()
    phase("phase 53: the bandit slice's modules card against CPU: LinUCB and disjoint LinUCB "
          "at D 500, the deep-represent trainer, every MAB algorithm, the replay evaluator, "
          "the dynamic LinUCB run in lockstep")
    cb_errors = bandit_card_cpu_phase(torch)

    phase("phase 54: K3 at the deep-represent score shapes, timed; the LinUCB step at D 500 "
          "and its pinv, the deep-represent step and score, the MAB loop timed")
    cb_timed = bandit_timed_phase(torch, name, launch_floor_ms)

    phase("phase 55: the four bandit jobs (dynamic LinUCB, replay evaluation, deep-represent, "
          "MAB) cut in depth")
    cb_jobs = bandit_jobs_phase(torch)
    log(f"  phases 53-55 took {time.perf_counter() - t_cb:.1f} s together")

    t_ope = time.perf_counter()
    phase("phase 56: the off-policy-estimation slice card against CPU: NNTrainer at 500 x 2, "
          "the MSLR slate job, NeuralDualDICE, the CartPole harness from one tape of draws")
    ope_errors = ope_card_cpu_phase(torch)

    phase("phase 57: K3 at the OPE shapes, timed; NNTrainer's train steps, a DualDICE step and "
          "the CartPole harness's rollout timed")
    ope_timed = ope_timed_phase(torch, name, launch_floor_ms)

    phase("phase 58: the OPE jobs (the CartPole harness, DualDICE on the gridworld, the slate "
          "benchmark with NNTrainer on the synthetic corpus and the MSLR sample) cut in depth")
    ope_jobs = ope_jobs_phase(torch)
    log(f"  phases 56-58 took {time.perf_counter() - t_ope:.1f} s together")

    t_imit = time.perf_counter()
    phase("phase 60: the imitation and counterfactual-evaluation slice card against CPU: "
          "behavioural cloning, the IPS-weighted bandit reward net and Bayes by backprop at "
          "the full width, the evolution pool from the same mutations")
    imit_errors = imitation_card_cpu_phase(torch)

    phase("phase 61: K3 on the imitator gate and on each Bayes-by-backprop sample, timed; the "
          "three trainers' steps and the ES pool timed")
    imit_timed = imitation_timed_phase(torch, name, launch_floor_ms)

    phase("phase 62: the parallel package at world size 1 on NCCL: the DP, MP and ES worker "
          "steps against their plain steps, the scaling sweep")
    par = parallel_phase(torch, name)
    log(f"  phases 60-62 took {time.perf_counter() - t_imit:.1f} s together")

    t_leaf = time.perf_counter()
    phase("phase 63: the leaf utilities card against CPU: the lite optimizers (random search, "
          "Q-learning, the MLP ensemble, policy gradient, Gumbel-softmax, Bayes by backprop "
          "at its defaults) and FrechetSort at [1,024, 20]")
    leaf_errors = lite_card_cpu_phase(torch)

    phase("phase 64: K3 at the Bayes-by-backprop surrogate's shape, timed; the optimizer's "
          "steps, StepTimer and trace over K2, grid_search through K2")
    leaf = leaf_timed_phase(torch, name, launch_floor_ms)

    phase("phase 65: the C++ decision service scores phases 6 and 7's artifacts")
    native_serving = native_serving_phase(torch, kept, service)
    kept_dir.cleanup()
    log(f"  phases 63-65 took {time.perf_counter() - t_leaf:.1f} s together")

    phase("phase 59: kernels (the summary of phases 1-65, printed last)")
    by_path = {
        "K1 fused_dqn_offline_update": {
            "offline workflow, full width": k1_launches,
            "device-resident fused loop, f32 twin": scan_f32["fused_dqn_offline_update"],
            "warm start and reward options, full width": warm["launches"]},
        "K1 fused_dqn_offline_update (bf16)": {
            "device-resident fused loop": scan_bf16["fused_dqn_offline_update_bf16"]},
        "K2 fused_dqn_update": {"offline workflow, CartPole sample": k2_launches,
                                "generic online loop": generic_launches["fused_dqn_update"],
                                **{f"{k} (CartPole sample config)": v
                                   for k, v in leaf["k2_launches"].items()}},
        "K2 fused_dqn_update_packed": {
            "fused online loop": fused_launches["fused_dqn_update_packed"]},
        "K3 fused_mlp_forward": {
            "fused online loop": fused_launches["fused_mlp_forward"],
            "generic online loop": generic_launches["fused_mlp_forward"],
            "evaluate_policy": eval_launches["fused_mlp_forward"],
            "offline QR-DQN workflow (q_values)": qr_launches["fused_mlp_forward"],
            "device-resident fused loop (q_values)": k3_scan_launches,
            "CPE evaluation, sample config": cpe_sample["launches"],
            "CPE evaluation, full width": cpe_full["launches"],
            "dqn_cartpole_e2e job (CPE evaluation)": e2e["launches"],
            "online CRR loop (the actor's act step)": crr_online["launches"]["fused_mlp_forward"],
            "online CRR evaluate_policy": crr_online["eval_launches"]["fused_mlp_forward"],
            "offline CRR job (actor_logits on 64 rows)": crr_job["k3_launches"],
            **{f"{k} episodes (act steps)": v["launches"]["fused_mlp_forward"]
               for k, v in pg.items()},
            **{f"{k} evaluate_policy": v["eval_launches"]["fused_mlp_forward"]
               for k, v in pg.items()},
            **{f"online {k} loop (act steps)": v["launches"]["fused_mlp_forward"]
               for k, v in fam_online.items()},
            **{f"online {k} evaluate_policy": v["eval_launches"]["fused_mlp_forward"]
               for k, v in fam_online.items()},
            **{f"offline {k} workflow (Q on 64 rows)": v["k3_launches"]
               for k, v in fam_offline.items()},
            **{f"online {k} loop (the actor's act step)": v["launches"]["fused_mlp_forward"]
               for k, v in cc_online.items()},
            **{f"online {k} evaluate_policy": v["eval_launches"]["fused_mlp_forward"]
               for k, v in cc_online.items()},
            "world-model DQN loop (act steps)": wm["launches"]["fused_mlp_forward"],
            "world-model evaluate_policy": wm["eval_launches"]["fused_mlp_forward"],
            "OpenGridworld DQN loop (act steps)": grid["launches"]["fused_mlp_forward"],
            "OpenGridworld evaluate_policy": grid["eval_launches"]["fused_mlp_forward"],
            "mask DQN evaluate_policy": mask["eval_launches"]["fused_mlp_forward"],
            "sparse changing-arms DQN loop (act steps)": arms["launches"]["fused_mlp_forward"],
            "sparse changing-arms evaluate_policy": arms["eval_launches"]["fused_mlp_forward"],
            "slate-Q on RecSim, collection (act steps)": ranking["train_act_steps"],
            "slate-Q on RecSim, greedy evaluation (act steps)": ranking["eval_act_steps"],
            "Seq2Reward job (the compress model's greedy steps and the short-sequence "
            "planner's step model)": mb_jobs["Seq2Reward CartPole"]["launches"][
                "fused_mlp_forward"],
            "deep-represent job (the greedy score)": cb_jobs["deep-represent"]["k3_launches"],
            **{f"OPE {k}": v["k3_launches"] for k, v in ope_jobs.items()},
            **{k: v["launches_a_call"] for k, v in imit_timed["k3"].items()},
            **{f"{k} (optimize steps)": v["launches"] for k, v in leaf["k3"].items()}},
        "K4 nstep_rewards": {"generic online loop": generic_launches["nstep_rewards"],
                             "online QR-DQN loop": qr_online_launches["nstep_rewards"],
                             "online CRR loop": crr_online["launches"]["nstep_rewards"],
                             **{f"online {k} loop": v["launches"]["nstep_rewards"]
                                for k, v in fam_online.items()},
                             **{f"online {k} loop" + (" (prioritized replay)"
                                                      if v["prioritized"] else ""):
                                v["launches"]["nstep_rewards"] for k, v in cc_online.items()},
                             "world-model DQN loop": wm["launches"]["nstep_rewards"],
                             "OpenGridworld DQN loop": grid["launches"]["nstep_rewards"],
                             "mask DQN loop": mask["launches"]["nstep_rewards"],
                             "sparse changing-arms DQN loop": arms["launches"]["nstep_rewards"]},
        "K5 quantile_huber_loss": {
            "offline QR-DQN workflow": qr_launches["quantile_huber_loss"],
            "online QR-DQN loop": qr_online_launches["quantile_huber_loss"]},
        "K5 quantile_huber_backward": {
            "offline QR-DQN workflow": qr_launches["quantile_huber_backward"],
            "online QR-DQN loop": qr_online_launches["quantile_huber_backward"]},
        "K5 quantile_huber_sums": {
            "offline QR-DQN workflow": qr_launches["quantile_huber_sums"],
            "online QR-DQN loop": qr_online_launches["quantile_huber_sums"]},
    }
    sources = {"K3": "reagent_tpu_torch/ops/csrc/fused_mlp.cu",
               "K4": "reagent_tpu_torch/ops/csrc/nstep_replay.cu",
               "K5": "reagent_tpu_torch/ops/csrc/quantile_huber.cu"}
    k5_shapes = {f"[{b}, {n}]": t for (b, n), t in k5_timing.items()}
    rows = []
    for kname, fn, replaces, err, times in (
        ("K1 fused_dqn_offline_update", fused_dqn_offline.fused_dqn_offline_update,
         "reagent_tpu/ops/fused_dqn_offline.py:240", max(err_k1, err_k1_cell), timing["K1"]),
        # the matmul_dtype=bfloat16 / save_dtype options (:71-72): the same
        # entry point, its products on the tensor cores
        ("K1 fused_dqn_offline_update (bf16)", None,
         "reagent_tpu/ops/fused_dqn_offline.py:240", max(err_k1_bf16, err_k1_save),
         timing["K1-bf16"]),
        ("K2 fused_dqn_update", fused_dqn.fused_dqn_update,
         "reagent_tpu/ops/fused_dqn.py:259", err_k2, timing["K2"]),
        # the packed interface reads the batch in place; both interfaces run
        # one C kernel, or the launch sequence where the shapes exceed it
        ("K2 fused_dqn_update_packed", fused_dqn.fused_dqn_update_packed,
         "reagent_tpu/ops/fused_dqn.py:259", err_k2p, online_timing["K2-packed"]),
        ("K3 fused_mlp_forward", None, "reagent_tpu/ops/fused_mlp.py:75", err_k3,
         online_timing["K3 [1, 4]"]),
        ("K4 nstep_rewards", None, "reagent_tpu/ops/nstep_replay.py:92", err_k4,
         online_timing["K4 loop"]),
        # K5's two launches, each at the offline path's [4096, 51]: the
        # forward on the gradient route, the main path's, and the backward
        # scaling its sums; the TPU kernel has no backward (XLA
        # differentiates its plain formulation)
        ("K5 quantile_huber_loss", None, "reagent_tpu/ops/quantile_huber.py:77", err_k5,
         (k5_main["sums"], k5_main["plain_sums"], *k5_main["bounds"]["sums"])),
        ("K5 quantile_huber_backward", None, "reagent_tpu/ops/quantile_huber.py:77",
         max(err_k5_grad, err_k5_scale),
         (k5_main["bwd"], k5_main["plain_bwd"], *k5_main["bounds"]["bwd"])),
    ):
        ms, plain_ms, b_ms, b_by = times[:4]
        row = {
            "name": kname, "route": "cuda",
            "source": sources.get(kname.split()[0], "reagent_tpu_torch/ops/csrc/fused_dqn.cu"),
            "replaces": replaces, "launches": sum(by_path[kname].values()),
            "launches_by_path": by_path[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes a DQN update, a fused MLP
            # forward, an n-step window sum or a pairwise quantile-Huber loss
            "library_ms": None,
        }
        if kname.startswith("K5"):
            # each route at each shape; the forward's row also carries the
            # loss-only route and the trainer's pair (forward with sums, then
            # the backward) as one function
            keys = {"K5 quantile_huber_loss": ("sums", "loss", "pair"),
                    "K5 quantile_huber_backward": ("bwd",)}[kname]
            row["by_shape"] = {
                shape: {key: {"ms": t[key], "plain_ms": t["plain_" + key],
                              "bound_ms": t["bounds"][key][0], "bound_by": t["bounds"][key][1]}
                        for key in keys}
                for shape, t in k5_shapes.items()}
        if kname == "K5 quantile_huber_loss":
            row["launches_on_the_gradient_route"] = sum(by_path["K5 quantile_huber_sums"].values())
        if fn is not None:
            row["cuda_kernels_per_launch"] = fn.kernels_per_update
        if kname.startswith("K2"):
            # phase 4 held each route to these counts (double-Q)
            row["cuda_kernels_per_launch_by_route"] = {
                "one launch (CartPole shapes)": ONE_LAUNCH[True],
                "launch sequence (D=128, 512, 256, A=8)": LAUNCH_SEQUENCE[True]}
            row["wrapper_host_us"] = host_us["K2-packed" if kname.endswith("packed") else "K2"]
        if kname == "K2 fused_dqn_update":
            seq = timing["K2 (launch sequence)"]
            row["launch_sequence"] = {"max_abs_err": err_k2_seq, "ms": seq[0], "plain_ms": seq[1],
                                      "bound_ms": seq[2], "bound_by": seq[3]}
        if kname.startswith(("K3", "K4")):
            row["wrapper_host_us"] = host_us["K3 [1, 4]" if kname.startswith("K3") else "K4 loop"]
            row["launch_floor_ms"] = launch_floor_ms
            other = online_timing["K3 [20, 4]" if kname.startswith("K3") else "K4 kernel phase"]
            row["by_shape"] = {other[-1]: {"ms": other[0], "plain_ms": other[1],
                                           "bound_ms": other[2], "bound_by": other[3]}}
        if kname.startswith(("K3", "K4")):
            # the kernel's device time in a step of the discrete-actor paths
            # (profiled windows of phases 31-32), as a share of its wall time
            key = "k3_us" if kname.startswith("K3") else "k4_us"
            paths = {"online CRR loop": (crr_online, "steps_per_s"),
                     **{f"online {k} loop": (v, "steps_per_s") for k, v in fam_online.items()},
                     **{f"online {k} loop": (v, "steps_per_s") for k, v in cc_online.items()},
                     "world-model DQN loop": (wm, "steps_per_s"),
                     "OpenGridworld DQN loop": (grid, "steps_per_s"),
                     "sparse changing-arms DQN loop": (arms, "steps_per_s")}
            if kname.startswith("K3"):
                paths.update({f"{k} episodes": (v, "episodes_per_s") for k, v in pg.items()})
                paths["slate-Q on RecSim collection"] = (ranking, "steps_per_s")
            else:
                paths["mask DQN loop"] = (mask, "steps_per_s")
            row["share_of_step"] = {
                path: {"device_us": run[key], "share": run[key] * run[rate] / 1e6}
                for path, (run, rate) in paths.items()}
        if kname.startswith("K3"):
            # the same forward as one torch.addmm per layer, at [1, 4]
            row["products_library_ms"] = k3_addmm_ms
            row["wrapper_host_us_by_shape"] = {"x [20, 4]": host_us["K3 [20, 4]"]}
            # the evaluation's forwards (phase 21), each with its addmm yardstick
            row["by_shape"].update({(k if k.startswith("q_values") else f"evaluation {k}"): v
                                    for k, v in k3_eval.items()})
        if kname.startswith(("K3", "K4")):
            # the C51 and parametric paths' shapes (phase 34)
            row["by_shape"].update(family_kernels[kname[:2]])
        if kname.startswith("K3"):
            # the continuous act and eval steps (phase 40) and the
            # world-model, gridworld and mask jobs' (phase 42), each with
            # the torch.addmm yardstick
            row["by_shape"].update(continuous_kernels)
            row["by_shape"].update(wm_k3)
            row["by_shape"].update(sparse_k3)
            row["by_shape"].update(ranking["k3"])
            row["by_shape"].update(mb_timed["k3"])
            row["by_shape"].update(cb_timed["k3"])
            row["by_shape"].update(ope_timed["k3"])
            row["by_shape"].update(imit_timed["k3"])
            row["by_shape"].update(leaf["k3"])
            # both routes: the kernel, the CUDA kernels a call (each shape's
            # row holds its profiled count) and the shapes each took here
            row["routes"] = {
                route: {"kernel": kernel, "cuda_kernels_a_call": per_call,
                        "shapes": [k for k, v in row["by_shape"].items()
                                   if isinstance(v, dict) and v.get("route") == route]}
                for route, kernel, per_call in (
                    ("resident", "fused_mlp_resident_kernel", "1"),
                    ("streamed", "mlp_layer_kernel", "one a layer"))}
        if kname.startswith("K4"):
            row["by_shape"].update(wm_k4)
            row["by_shape"].update(sparse_k4)
        if kname.startswith("K1"):
            # the same products through cuBLAS, and the kernel's own GEMM share
            key = "K1-bf16" if kname.endswith("(bf16)") else "K1"
            row["products_library_ms"] = products[key]
            row["gemm_device_us"] = gemm_us[key]
        if kname.endswith("(bf16)"):
            row["cuda_kernels_per_launch"] = (
                fused_dqn_offline.fused_dqn_offline_update.bf16_kernels_per_update)
            row["mma"] = "mma.sync m16n8k16 bf16, f32 accumulators, cp.async and ldmatrix"
        rows.append(row)
    # the sparse embedding step is torch operations (JAX's is an XLA op, no
    # pallas_call): its numbers stand beside the kernels, not among them
    log(json.dumps({"sparse_embedding_step": sparse_scale}))
    # Seq2Slate's products and attention are torch operations (JAX computes
    # them outside any pallas_call): its numbers stand beside the kernels
    log(json.dumps({"seq2slate": s2s_timing}))
    # the model-based slice's world models, planners and Seq2Reward are torch
    # operations (JAX's reach no pallas_call): their numbers stand beside
    log(json.dumps({"model_based": {"card_vs_cpu_max_abs": mb_errors,
                                    "timed": {k: v for k, v in mb_timed.items() if k != "k3"},
                                    "jobs_cut": mb_jobs}}))
    # the bandit slice's LinUCB solves, MAB loops and evaluator are torch
    # operations (JAX's reach no pallas_call): their numbers stand beside
    log(json.dumps({"bandits": {"card_vs_cpu_max_abs": cb_errors,
                                "timed": {k: v for k, v in cb_timed.items() if k != "k3"},
                                "jobs_cut": cb_jobs}}))
    # the OPE slice's estimators are numpy, its trainers torch (JAX's reach no
    # pallas_call): their numbers stand beside the kernels
    log(json.dumps({"ope": {"card_vs_cpu_max_abs": ope_errors,
                            "timed": {k: v for k, v in ope_timed.items() if k != "k3"},
                            "jobs_cut": ope_jobs}}))
    # the slice's trainers, ES pool and parallel steps are torch operations
    # (JAX's reach no pallas_call): their numbers stand beside the kernels
    log(json.dumps({"imitation_cfeval_parallel": {
        "card_vs_cpu_max_abs": imit_errors,
        "timed": {k: v for k, v in imit_timed.items() if k != "k3"}, "parallel": par}}))
    # the leaf utilities are numpy, torch and the C++ service (JAX's reach no
    # pallas_call): their numbers stand beside the kernels
    log(json.dumps({"leaf_utilities": {
        "card_vs_cpu_max_abs": leaf_errors,
        "timed": {k: v for k, v in leaf.items() if k != "k3"}, "native_serving": native_serving}}))
    phase("phase 66: K3's CUDA kernels a call at every K3 row's shape (torch.profiler, a "
          "fresh process)")
    n_k3_rows = k3_kernels_phase()
    log(f"  {n_k3_rows} K3 rows counted")
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--k3-kernels-a-call"]:
        sys.exit(k3_kernels_child(sys.argv[2]))
    sys.exit(main())
