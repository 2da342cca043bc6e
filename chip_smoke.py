#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ompi_tpu_torch``) on one NVIDIA
card: the quickest proof that the port still builds, runs and agrees
with itself on the GPU.

    python3 chip_smoke.py

Phases, one or more lines each:

1. device     — the card (``nvidia-smi`` name and power limit), torch and
                CUDA versions.
2. build      — every CUDA kernel of the port, built with ``nvcc`` from
                ``ompi_tpu_torch/csrc`` (one process per source, in
                parallel) into the git-ignored build directory.
3. kernels    — each kernel's wrapper against its plain torch version on
                the card, at the shapes the main path gives it, at larger,
                ragged and ring-block ones, and at edge shapes that reach
                every compiled instantiation; max abs error and the share
                of the tolerance it uses. Per timed shape and mask mode:
                device time (median of CUDA-event timings), the plain
                version's time, the least time the card could take
                (``bound``, from ``fold_work``), the all-scores fp32 bound, the
                launch floor, and SDPA on 4-D views as the library's
                yardstick (modes 0 and 1, fresh accumulators).
4. collectives — ``Init(devices=[cuda:0] * 8)`` and the Standard journey
                on 32 MB fp32 per rank (256 MB stacked), every result
                checked against numpy on a host copy.
5. flagship   — ``entry()``'s forward under ``torch.no_grad()`` at its
                batch (2) and at batch 64, through the flash-fold kernel
                (its launch count read around these runs), against the
                same forward through the plain fold.
6. train      — ``dryrun_multichip(8)`` on the card (the JAX dryrun's
                pp=2 x dp=1 x tp=2 x sp=2 step, dp=2 against dp=1, Ulysses
                against dense attention) and the same ``_run_flagship``
                on the CPU, whose losses must match the card's; the
                combined step at the flagship's full width (float32,
                MoE), with replicated leaves checked across ranks after
                each step; the dense ``sgd_train_step`` on dp=2 x tp=2 x
                sp=2 against the single-device step. Step times (host
                clock), peak memory, and no kernel launch in training.
7. nonblocking — on the same 8-rank world: every ``i*`` entry at 32 MB
                and at 37 elements per rank (the ``coll/nbc`` fused round
                and its ring/binomial schedules) against its blocking
                counterpart; persistent plans started 10 times over a
                buffer changed in place; ``Startall`` over the flagship's
                gradient-shaped leaves with bucket fusion on and off; and
                the DDP train step at the flagship's full width on dp=8
                (``BucketedGradSync``, bucket on and off) against the
                in-graph dp pmean step. Host and device times, device
                busy share, fused flushes per step, peak memory, and no
                kernel launch in training.
8. algorithms — every algorithm schedule of ``coll/torch`` forced through
                its ``coll_torch_<func>_algorithm`` var: at 37 elements
                per rank on the 8-rank world and on split
                sub-communicators of sizes 3, 5 and 6, each against the
                direct lowering on the card, bit for bit against the same
                schedule on the CPU port where it combines with ``op.fn``
                alone, and what ran against the reference's demotion
                rules; then at 32 MB per rank on the 8-rank world, each
                checked against the direct lowering and timed (device ms,
                share of HBM, host µs per dispatch). Phase 4 prints what
                ``auto`` picked beside each of its times.
9. compression — on the same world: each real codec's torch half at 32
                MB on the card against the CPU, bit for bit, with
                poisoned blocks, within ``error_bound``; allreduce SUM,
                allgather and reduce_scatter_block on a communicator
                dup'ed with ``mpi_base_compress`` on, per codec (int8,
                fp8, null) at 4 and 32 MB per rank, against float64
                numpy within the reference's envelopes, rows identical,
                bit for bit against the CPU port, with the wire ratio
                from the pvars, device ms against the uncompressed
                schedules and host µs per dispatch; the gates (var off,
                MAX, int32, under the floor: bit-identical, no byte
                counted); ``allreduce_bind``, a compressed plan and a
                fused ``Startall`` bucket; the DDP step with compressed
                buckets against the uncompressed one; the v- and
                root-form collectives with ragged counts against numpy.
10. ptp_topo_datatype — on the same world: a sendrecv ring of eight 32 MB
                messages (receives posted first, then sends first), each
                unchanged after its sender wrote over the buffer, bit for
                bit against numpy and the CPU port; ``ssend`` against a
                posted ``irecv``; partitioned pt2pt with 16 x 2 MB
                partitions; host µs of an 8 B send+recv pair and of an
                ANY_SOURCE/ANY_TAG match with 256 messages queued. A vector
                and a subarray type on a (4096, 2048) fp32 matrix per rank:
                pack/unpack, the fused in-place ``allreduce_dtype`` SUM
                against the unfused ``_wire`` chain and a contiguous
                allreduce of the same bytes (holes bit for bit, the sum
                against float64 numpy, MAX bit for bit against the CPU
                port), ``bcast`` with the vector type, ``reduce_local``,
                ``alltoallw``, an overlapping type's keep-last unpack, and
                the convertor on every predefined type. A 2x4 cart, a
                dist-graph with duplicate edges and a reordered graph:
                ``neighbor_allgather``/``alltoall`` and their ragged v-forms
                against the host path and the CPU port, bit for bit, with
                device ms and share of HBM. ``split_type``, ``create`` and
                attributes through ``dup``/``free``.
11. perrank   — ``ompi_tpu_torch/tools/mpirun.py --per-rank -n 8`` runs this
                script as its rank program (``--perrank-rank``): eight rank
                processes, each bound to ``cuda:0``. On the shared-buffer
                device tier (CUDA IPC slots) with 32 MB fp32 per rank:
                allreduce SUM/MAX/PROD and int32 SUM, MAXLOC on 9 and 2**20
                (value, index) records, bcast, allgather, alltoall, and
                reduce_scatter_block through the host fold;
                numpy staged onto the device tier above a set
                ``coll_tuned_stage_min_bytes``; host-tier numpy collectives
                at 37 elements; a devxfer ring of eight 32 MB CUDA messages,
                each unchanged after its sender overwrote its buffer; 8 B
                send+recv and a wildcard match; ``split`` into two comms of
                4 with an allreduce on each. Every rank checks every result
                against numpy and that every device result is a CUDA tensor
                on ``cuda:0``; rank 0 prints call ms (a CUDA-event span
                that includes the host fences), bytes over that span as a
                share of HBM, and host µs per 8 B round trip and per
                dispatch. Any rank failing, or the job passing its timeout,
                fails the phase.
12. dataplane — the tuned component on the single-controller 8-rank
                world: a numpy (8, 1 MiB fp32) stack returns numpy equal to
                coll/torch on the same tensor, staged and on the host (ms
                of each). Then the per-rank large-message data plane, 8
                rank processes on ``cuda:0`` (``--dataplane-rank``; rails 2,
                two shared slots per pool): the staging probe rank 0 ran on
                the card at Init, adopted alike by every rank; with the
                host tier forced, the pipelined ring allreduce (SUM f32,
                MAX f32 and i32) and the chain bcast on 32 MB per rank
                against numpy, the same bits on every rank, both rails
                carrying bytes at rails 2 and only rail 0 at rails 1;
                the in-segment fold (``mpi_base_shm_zerocopy``) against
                the ring (MAX bit for bit, SUM rtol 1e-5) and
                pt2pt adoption counted by the shmseg pvars; a 32 MB CUDA
                tensor sent past devxfer's limit, staged segment by
                segment through ``SegmentStager`` and unchanged after its
                sender overwrote it, against the devxfer ring in the same
                job; compressed host hops (int8_block, fp8_block) on the
                direct allreduce (comms of 4), the reduce and the bcast
                within the reference's envelopes, the same bits on every
                rank; persistent plans (device tier, staged numpy on
                pinned pages, 8 B small combine) bit for bit against their
                one-shot calls and a 14-plan bucketed ``Startall``. The
                ring and chain are timed on 1 and 2 rails in turns
                (``mpi_base_btl_rails`` is read per segment). The job has
                its own 300 s launcher limit.
13. observe   — on the live 8-rank world on ``cuda:0``, before
                ``Finalize``: tracing and monitoring on for a ``dup()``,
                each of allreduce, bcast, reduce, allgather, gather,
                scatter, alltoall,
                reduce_scatter_block, scan and barrier at 32 MB fp32 per
                rank, twice: bit for bit the plain world's result, one
                ``coll_<func>`` span per call (the dup's cid, seq 0 and 1)
                and a ``coll.body`` per call with a body on either comm,
                a Perfetto export that loads as JSON, monitoring bytes equal
                to the payloads, SPC counts equal to the calls; a ring of 64
                under 1000 calls counting its drops; host µs per 8 B
                allreduce with tracing off and on, and with the SPC
                counters off and on, each in turns. uint16/32/64 x
                SUM, PROD, MAX, MIN, BAND on tensors and staged numpy stacks,
                exact against numpy. ``pml_v_protocol=pessimist``: wildcard
                receives of 1 MiB CUDA tensors logged, a replay from the
                JSON snapshot forcing the logged order, redelivery bit for
                bit after the senders overwrote their buffers. Then 8 rank
                processes on ``cuda:0`` with tracing on
                (``--observe-rank``; 300 s launcher limit): rank 5 sleeps
                200 ms before the third 32 MB device allreduce, every rank
                dumps its spans and rank 0's ``late_arrival`` must name rank
                5 with a skew of at least 150 ms; a 32 MB host-tier ring
                with ``pml_send``, ``pml_recv``, ``pml.segment`` and
                ``btl.rail`` spans and one ``coll_allreduce`` span per call;
                ``coll_sync_barrier_before=3`` leaving results unchanged; a
                32 MB CUDA tensor sent from rank 0 to rank 1 in 4
                partitions (``pready`` 2, 0, 1, 3), twice through the same
                requests, bit for bit; µs per 8 B round trip with tracing
                off and on, in turns.
14. resilience — on the live 8-rank world on ``cuda:0``, before
                ``Finalize``: telemetry on for a ``dup()`` (every slot
                wrapped), the Standard collectives at 32 MB per rank
                against numpy, calls counted per func, the 32 MB
                allreduce histogram's p50 beside its CUDA-event time; the
                dup's ``trace_skew_c<cid>`` and histogram pvars gone after
                ``free()``; Prometheus text and a telemetry dump; host µs
                per 8 B allreduce with the plane off and on, in turns.
                ``fail_rank(3)``: allreduce, send and recv naming rank 3
                raise ``ERR_PROC_FAILED``; revoke, agree (reporting rank
                3) and shrink to 7 ranks; the 32 MB allreduce on the
                survivors' rows of the stacked tensor against numpy, ms
                before and after; ``BucketedGradSync.shrink`` and one
                full-width DDP step on the 7 ranks against the in-graph
                pmean step; ``probe_devices`` on the 8 handles. Then 8
                rank processes on ``cuda:0`` (``--resilience-rank``,
                ``mpirun --enable-recovery``, telemetry, heartbeats at
                p34's settings and the zero-copy pools on): rank 5 exits
                at its 2nd allreduce; the survivors detect it within 2x
                the heartbeat timeout with nobody else declared, revoke,
                agree and shrink, run a 32 MB CUDA allreduce on the 7 and
                a devxfer ring against exact sums, and leave flight
                records that ``flightrec.merge`` reads as an incident
                naming rank 5; the job's rc is 137, no survivor's stderr
                shows a CUDA error, and no ``otpt*`` file of the job is
                left in ``/dev/shm``.
                ``python3 chip_smoke.py --perrank`` runs phases 1, 11, 12,
                13 and 14's job alone; ``--resilience`` runs phases 1 and
                14 alone.
15. sessions  — on the 8-rank world before phase 14 fails a rank of it,
                32 MB fp32 per rank: (a) two ``Session(devices=[cuda:0] *
                8)`` with ``ring`` and ``recursive_doubling`` in their own
                var scopes (the world keeps ``auto``): each session's
                deferred iallreduce builds only its algorithm, its
                allreduce = numpy, ``selected()`` names it, CIDs come from
                its own space, a failure injected in one session's
                registry stays there, finalize frees every comm; 8 B
                allreduce host us on a session comm against the world in
                turns. (b) ``Comm_spawn(child_main, 4, world)``: a 4-row
                child on ``cuda:0``; the intercomm's bcast, allreduce,
                allgather and alltoall against numpy with every output on
                the card; ``merge`` to 12 rows; ports,
                names, join and disconnect; the intercomm allreduce's
                device ms. (c) han (``coll_han_split=4``) and xhc (``2,2``
                and the auto ladder) on dups of the world against numpy and
                against coll/torch's direct lowering (MAX and int32 bit for
                bit, float SUM rtol 1e-5), a small han message going
                flat; adapt's 1 MB segments at 32 MB against the blocking
                calls bit for bit, the callback once; device ms beside
                direct's (no gain is claimed). (d) acoll's empty detection
                on the card, ``mem_alloc``, ``event_synchronize``, the
                in-process IPC round trip, the device queries. In a fresh
                process (``--fresh-check``), no ``Memcpy DtoH`` event
                inside the intercomm, han and xhc calls (torch.profiler,
                with a ``.cpu()`` control: this process's profiler stops
                reporting memcpy records after phases 3 and 4), and the
                8 B allreduce on a session comm against the world again.
                Then,
                after phase 14's job, (e) two 2-rank jobs bridged through
                ``dpm_perrank`` (messages both ways from every rank, a CUDA
                tensor arriving as numpy with the same bits) and a 3-rank
                job running two sessions on CUDA tensors over the device
                tier, all three at once, each under a 60 s limit.
                ``python3 chip_smoke.py --sessions`` runs phases 1 and 15
                alone.
16. onesided  — on the 8-rank world before phase 14 fails a rank of it:
                (a) the native host library (g++ of ``native/*.cpp``,
                built in phase 2 beside nvcc): every entry point the paths
                call, counted through a wrapper swapped in for
                ``native.get_lib``; the per-rank host fold (SUM, MAX) on 8
                numpy rows of 32 MB fp32, coll/basic's BAND/BXOR/LAND fold
                on int32, reduce_local over 10 dtypes x 10 ops with NaNs,
                a vector and an indexed type packed and unpacked from a
                (4096, 2048) host matrix, each bit for bit against its
                numpy route with host ms beside it; the 8 x 32 MB ring and
                256 wildcard matches with the native matching core and the
                Python one, in the same order. (b) ``Win`` on ``cuda:0``, 8
                x 32 MB fp32: put ring, get, accumulate SUM/MAX/REPLACE/
                NO_OP (and on uint32), get_accumulate, fetch_and_op,
                compare_and_swap, rput/raccumulate, PSCW, lock, attach,
                against numpy, every row on the card; device ms of a 32 MB
                put and accumulate from a CUDA and a numpy origin beside
                their bounds. (c) after phase 15's jobs, all at once: p43
                on osc/shm (with a telemetry dump's ``osc`` section and a
                flight record's ``osc_epochs``) and on osc/pt2pt, 4 ranks
                at 32 MB per window from CUDA origins; p13 on 3 ranks; p44
                (rank 2 SIGKILLed in a fence epoch, rc 247, no ``otpt*``
                file left); and in a fresh process (``--osc-fresh-check``)
                0 ``Memcpy DtoH`` in put and accumulate from a CUDA origin,
                with a ``.cpu()`` control. The phase must end within 90 s.
                ``python3 chip_smoke.py --onesided`` runs phases 1 and 16
                alone.
17. planes    — on the 8-rank world before phase 14 fails a rank of it,
                32 MB fp32 per rank: (a) ``ShmemCtx`` over the 8 PEs with
                a 2**23-element heap each (256 MB on ``cuda:0``, served by
                the native buddy allocator): puts from CUDA origins, get,
                collect, fcollect, broadcast, sum_to_all and max_to_all
                (the PE-order float32 fold) and alltoall against numpy bit
                for bit, with device ms; on an int32 heap,
                atomic_fetch_add, compare_swap, a lock round and the
                bitwise atomics, with µs per fetching atomic (each reads
                one element back). (b) a ``File`` on the world in a temp
                dir (its ``df -T`` type printed): write_at_all and
                read_at_all of the stacked 8 x 32 MB CUDA tensor bit for
                bit (ms, GB/s), a strided vector view, the shared pointer,
                write_ordered/read_ordered. (c) ``entry()``'s params in
                bf16 and the stacked tensor checkpointed from the card and
                restored with ``comm=world``: every leaf bit for bit on
                ``cuda:0``, the dense forward's logits bit for bit (ms per
                save and restore). (d) ``mpi_memchecker_enable`` on: a
                partitioned send of 4 x 8 MB CUDA partitions completes
                clean, and a write after ``pready`` raises
                ``MemcheckError`` at completion. (e) ``Query_cuda_support``,
                ``Device_inventory`` naming the card, fp16 and bf16
                allreduce at 32 MB per rank against float64 numpy (rtol
                2e-2), affinity strings naming ``cuda:0``, the ``"gpu"``
                rows of ``decision_table(8)``, a cvar write read back.
                Then, after phase 16's jobs, (f) all at once: the port's
                p14, p20 and p21 (the programs of
                ``tests/test_torch_planes_perrank.py``) on 3 ranks with
                CUDA origins, a 4-rank ``RankFile`` job writing 32 MB per
                rank from a CUDA tensor and reading every peer's block
                back bit for bit, and a fresh process
                (``--planes-fresh-check``) counting 0 ``Memcpy DtoH`` in
                the shmem puts and heap collectives from CUDA origins and
                no payload copy in the memchecker's marks (one scalar per
                ``verify``), with a ``.cpu()`` control; no ``otpt*`` file
                left. The phase must end within 90 s. ``python3
                chip_smoke.py --planes`` runs phases 1 and 17 alone.
18. tools     — on the 8-rank world before phase 14 fails a rank of it:
                (a) a dup built with tracing, telemetry and monitoring
                on runs allreduce, bcast and allgather 3 times each at
                32 MB fp32 per rank (= the plain world) and CUDA sends
                of 4 KB, 4 MB and 32 MB; the port's tools read it:
                ``mpitop`` counts the 9 calls, ``tracedump`` one span per
                call and a Perfetto JSON that parses,
                ``profile.pt2pt_matrix`` = the bytes sent and
                ``coll_table`` = the calls, ``comm_method`` platform
                ``gpu`` with the framework's winners, ``info`` the CUDA
                device and the native library, ``proctable`` 8 x
                ``cuda:0``, ``message_queues`` a posted ``irecv`` that
                then takes a CUDA payload, PERUSE once per CUDA send;
                host ms per tool call; a fresh process
                (``--tools-fresh-check``) counts 0 ``Memcpy DtoH`` in
                every tool call with a ``.cpu()`` control. (b) two 8-rank
                jobs on ``cuda:0``, one after the other
                (``--tools-rank``): the port's p40 under
                ``mpi_base_lockwitness=1`` with 4 MB CUDA payloads over
                devxfer (graph acyclic, the 8 dumps merged by
                ``tracedump``), then ``mpisync.sync_report_perrank``
                (each |offset| <= its rtt) and ``comm_method`` on the
                per-rank world; each times the 8 B allreduce (witness on,
                off); every rank OK inside 60 s, no ``otpt*`` file left.
                (c) the port's ``mpilint`` over ``ompi_tpu_torch/``: 0
                unbaselined findings, 0 stale entries. The phase must
                end within 90 s. ``python3 chip_smoke.py --tools`` runs
                phases 1 and 18 alone.
19. cabi      — the MPI C ABI on the card. (a) On the 8-row world of
                ``cuda:0`` (before phase 14 fails a rank of it): the
                single-controller glue's five nonblocking-collective
                contracts of ``tests/test_cabi_async.py`` (async issue,
                issue order, deferred error at wait, worker retired with
                its comm, ``comm_free`` drains), against numpy. (b) After
                phase 18's jobs: the port's ``mpicc`` builds
                ``libtpumpi_torch.so`` and 11 programs of
                ``tests/cabi_programs/`` from the checkout, with an MPI_T
                probe (a PMPI tool the phase writes) and ``pmpi_tool.c``;
                each program runs under the port's ``mpirun --per-rank``
                with no device override, so every rank binds ``cuda:0``:
                ``c13_staged`` alone at 64 MB per rank under the probe
                (``coll_staged_device`` > 0 on every rank, its own timing
                line, ``cuda:0``'s free memory during the job), then the
                rest four at a time and the PMPI tool under c03; every
                rank prints its ``OK`` line; seconds per job; 0
                flash-fold launches over the phase; no ``otpt*`` file
                left. ``python3 chip_smoke.py --cabi`` runs phases 1 and
                19 alone.
20. multictl  — the multi-controller world on the card: two controller
                processes, each launched by the port's ``mpirun
                --coordinator 127.0.0.1:<port> --num-hosts 2 --host-id
                {0,1} -n 4`` (``--multictl-rank``), each holding 4 rows
                on ``cuda:0``, together one 8-rank COMM_WORLD whose
                collectives cross the controller tier (CUDA IPC slots of
                the per-rank tier). Each controller checks, on its own
                rows: the ten Standard collectives at 32 MB fp32 per rank
                against numpy on host copies (MAX, MIN, int32 and data
                movement exact, float SUM, PROD and scan rtol 1e-5, atol
                1e-5), every result on ``cuda:0``; ``hier`` forced and
                chosen by ``auto`` for allreduce, bcast, allgather,
                reduce_scatter_block and barrier, against ``direct``
                (across controllers both are one exchange: the same bits,
                so neither is timed apart); ``_groups()`` = [[0..3], [4..7]] / [[0, 4], [1, 5], [2, 6],
                [3, 7]]; the compressed hier allreduce (int8) within the
                reference's envelope; a split spanning both controllers;
                the single-controller guards and a remote row's
                ``ERR_RANK``; 0 ``Memcpy DtoH`` records of payload size in
                the crossing allreduce and bcast (torch.profiler, with a
                ``.cpu()`` control); ``Session()``'s psets (ranks 0-7,
                one ``mpix://shared/<controller>`` each) and the
                allreduce SUM and bcast of comms made from
                ``mpi://WORLD`` and ``mpix://shared/<controller>``
                against numpy; mpisync's table (own rows ``controller``,
                the other's ``process_<i> (unprobed)``); han, then xhc,
                forced by priority on COMM_WORLD: allreduce SUM f32, MAX
                f32, SUM i32 and bcast against numpy and the forced
                direct schedule (MAX, i32 and bcast bit for bit, SUM
                rtol 1e-5), ``HanModule`` / ``XhcModule`` providing
                allreduce and bcast, 0 payload-sized ``Memcpy DtoH`` in
                their allreduce (with a ``.cpu()`` control); 0
                flash-fold launches. Controller 0
                prints each collective's ms (a CUDA-event span that
                includes the tier's host fences, and the host clock)
                beside phase 4's single-controller and phase 11's
                per-rank ms of the same call, the bytes each controller
                wrote into and read from the tier, each session, han and
                xhc call's ms beside the plain world's call of the same
                run, and each controller's start-up seconds; every
                controller OK inside 150 s (phases 20 and 21), no
                ``otpt*`` file left. ``python3 chip_smoke.py --multictl``
                runs phases 1, 20 and 21 alone.
21. schedules — in phase 20's job, after its checks: every explicit
                schedule of ``coll/torch`` forced on the spanning
                COMM_WORLD (27: ring, Bruck, trees, pairwise, recursive
                doubling, ...) at 1 MB fp32 per rank, SUM f32, MAX f32
                and SUM i32 for the reducing collectives, root 7 for the
                root forms; each held bit for bit against the same
                schedule on an 8-row single-controller comm on
                ``cuda:0`` made in the controller process (within rtol
                1e-5 where the reference's rules demote it to direct),
                against numpy as phase 20, ``selected`` against the
                reference's rules, and each controller's tier bytes out
                against what the steps' index arrays move off it; the
                ring and ring_segmented allreduce, ring allgather,
                pairwise alltoall and binomial bcast at 32 MB per rank,
                each timed beside direct in the same run (CUDA-event
                span with the host fences), 0 payload-sized ``Memcpy
                DtoH`` in them (counted in phase 20's one profiler
                session); nbc's ring iallreduce with controller 1 late
                (first its test() calls, then its start), equal bit for
                bit to the blocking ring, each test() under 50 ms; C9's
                programs on fresh dups A and B of the world, controller 0
                calling in one order and controller 1 in the other ((a)
                ``B.i<func>`` then the blocking ``A.<func>``; (b) both
                nonblocking, waited in start order) for iallreduce SUM
                f32, ibcast root 7 and iallgather at 1 MB per rank and a
                (b) iallreduce pair at 32 MB per rank, each result bit
                for bit its comm's blocking call, the pair's CUDA-event
                span beside the same two calls one after the other, and
                each controller's live tiers, workers and slot bytes
                before the dups, with them and after their ``free``
                (the same as before, or the phase fails); 0 flash-fold
                launches; the phase aimed under 90 s.
                ``python3 chip_smoke.py --algorithms`` runs phases 1 and
                8 alone.
22. multihost — the multi-controller world across hosts, in a job of its
                own after phase 21's: three controller processes on
                ``cuda:0`` (``--multihost-rank``) with 4, 2 and 2 rows,
                controllers 0 and 1 on host A and controller 2 on an
                emulated host B (its own host identity and shared-memory
                directory, set before ``Init``). COMM_WORLD spans hosts
                and its controller tier runs staged (each payload off the
                card once, raw bytes over the tier's tcp plane, the fold
                on ``cuda:0``); the split over controllers 0 and 1 spans
                one host and takes the slots. On both, at 1 MiB fp32 per
                rank (nbc and the bucket at 37-39 elements): allreduce
                SUM f32, MAX f32, SUM i32 and MINLOC, bcast, allgather,
                alltoall, forced ring allreduce and Bruck allgather, an
                nbc iallreduce and a bucketed pair, each bit for bit
                against an 8-row (6-row) single-controller comm on
                ``cuda:0`` in the controller process (the direct float
                sums within rtol 1e-5: the controllers' partials fold in
                another association; the bucket = its unfused calls bit
                for bit) and against numpy as phase 4; the tiers' gates
                (staged on the world, slots on the split, no host
                staging across hosts); on the split's tier every device
                body staged against its slots, bit for bit; the 32 MiB
                allreduce SUM staged and on slots (CUDA-event ms with the
                host fences), each controller's tier bytes against what
                the steps owe; ``Memcpy DtoH`` records per crossing (2 on
                the staged path: the partial, then the folded chunk; none
                of payload size on the slots; a ``.cpu()`` control); 0
                flash-fold launches; the phase aimed under 60 s, the job
                limit 90 s. ``python3 chip_smoke.py --multihost`` runs
                phases 1 and 22 alone.
23. bucketfold — right after phase 3: the bucket fold
                (``ops/bucket_fold``, ``csrc/bucket_fold.cu``) on a bucket
                of the DDP cell (GPT-2 medium's gradients at DDP's 25 MiB
                cap: 10 members, 32 MiB a rank, 8 rank rows, each member
                a tensor of its own): bit for bit against the plain fold;
                device ms (CUDA events, median of 30) of the kernel, of the
                plain fold and of the flush's old pack, direct allreduce
                and unpack on the same members; the bound (``fold_bytes``
                at 3.35 TB/s) and the kernel's bytes per second as a share
                of it. ``python3 chip_smoke.py --bucketfold`` runs phases
                1, 2 and 23 alone.

Then a JSON line with one record per kernel, the ``nvidia-smi`` line, and
as the last line ``{"ok": true, "device": {...}}``. Any failure raises:
the script exits non-zero and prints no result. Without a CUDA device it
exits non-zero at once.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend

import ompi_tpu_torch as MPI
from ompi_tpu_torch import accelerator
from ompi_tpu_torch import entry as E
from ompi_tpu_torch.coll import decision, persistent
from ompi_tpu_torch.coll.nbc import ScheduleRequest
from ompi_tpu_torch.coll.torch_ import ALGORITHMS
from ompi_tpu_torch.compress.codecs import get_codec
from ompi_tpu_torch.core import convertor
from ompi_tpu_torch.entry import CONFIG, entry
from ompi_tpu_torch.models import transformer as T
from ompi_tpu_torch.ops import _build
from ompi_tpu_torch.mca import pvar, var
from ompi_tpu_torch.ops import bucket_fold as BF
from ompi_tpu_torch.ops import flash_attention as FA
from ompi_tpu_torch.parallel import InGraphComm, Mesh, P
from ompi_tpu_torch.parallel.mesh import tree_leaves, tree_map

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 outside
# the tensor cores, TF32 on them (3xTF32 runs three TF32 products for each
# fp32 one), and HBM3 bandwidth.
FP32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3
HBM_BYTES_PER_S = 3.35e12

N_RANKS = 8
LOCAL_ELEMS = 8 << 20          # 32 MB of fp32 per rank, 256 MB stacked
# per-collective ms of phases 4 and 11, printed beside phase 20's
COLL_MS: dict = {}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def device_ms(fn, iters: int = 30, warmup: int = 5) -> float:
    """Median device time of one ``fn()`` in ms, from CUDA events. A
    sleep kernel queued before each start event keeps the queue full, so
    the events time the device's work and not the host's launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Median wall time of one ``fn()`` in ms, synchronised."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# -- phase 1 -----------------------------------------------------------
def phase_device() -> tuple:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" | CUDA {torch.version.cuda} | count "
          f"{torch.cuda.device_count()}")
    # a float32 reference is full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, kind


# -- phase 2 -----------------------------------------------------------
def _ptxas_summary(log: str) -> list:
    """'kernel<DP>: R registers, S B spilled' for each kernel that
    ``nvcc -Xptxas=-v`` compiled."""
    out, name, spill = [], "?", "0"
    for ln in log.splitlines():
        entry_fn = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry_fn:
            m = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", entry_fn.group(1))
            name = (m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
                    if m else entry_fn.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
    return out


def phase_build() -> None:
    """Every CUDA kernel (one nvcc per source) and, beside them on a
    thread, the native host library (g++ of native/*.cpp)."""
    import threading
    from ompi_tpu_torch import native
    from ompi_tpu_torch.native import loader
    t0 = time.perf_counter()
    host = threading.Thread(target=native.get_lib)
    host.start()
    built = _build.build_all(verbose=True)
    host.join()
    for name, rec in built.items():
        phase("build", f"{name}: {rec['seconds']:.2f} s "
              f"{' | '.join(_ptxas_summary(rec['log']))}")
    check(native.native_available(), f"the native library did not build: "
          f"{native.build_error()}")
    phase("build", f"native host library {loader.lib_path().name}: "
          f"{loader.build_seconds():.2f} s (g++ -O3, native/*.cpp)")
    phase("build", f"all kernels built in {time.perf_counter() - t0:.2f} s")


# -- phase 3 -----------------------------------------------------------
def _fold_inputs(BH, Sq, Sk, D, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(s, device="cuda", generator=g)  # noqa: E731
    q = rnd(BH, Sq, D) * D ** -0.5
    k, v = rnd(BH, Sk, D), rnd(BH, Sk, D)
    fresh = (torch.zeros(BH, Sq, D, device="cuda"),
             torch.full((BH, Sq), -1e30, device="cuda"),
             torch.zeros(BH, Sq, device="cuda"))
    return q, k, v, fresh


def _err_share(got, want, atol, rtol, what):
    """Max abs error and the largest share of the tolerance it uses:
    max of err / (atol + rtol * |want|); the check fails above 1."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - want).abs()
    share = (err / (atol + rtol * want.abs())).max().item()
    check(share <= 1.0, f"{what}: max abs err {err.max().item():.3g} "
          f"beyond atol {atol} rtol {rtol}")
    return err.max().item(), share


def _fold_bound(BH, Sq, Sk, D, mode, fresh_heads=0):
    """The least time the card could take for the fold: the larger of the
    flops the mask allows at the 3xTF32 rate and the bytes the mode must
    move at the HBM rate (``fold_work``); and the all-scores bound, every
    score counted at the fp32 rate, as the first CUDA fold was measured."""
    flops, nbytes = FA.fold_work(BH, Sq, Sk, D, mode, fresh_heads)
    t_ops, t_bytes = flops / TF32X3_FLOPS, nbytes / HBM_BYTES_PER_S
    fp32 = max(4 * BH * Sq * Sk * D / FP32_FLOPS,
               4 * BH * (3 * Sq * D + 2 * Sk * D + 4 * Sq) / HBM_BYTES_PER_S)
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", fp32 * 1e3)


def _instantiation(q, k, v):
    """(padded head width, copy width) the kernel picks for these inputs,
    as flash_fold_f32 picks them."""
    D = q.shape[-1]
    dp = next(w for w in (16, 32, 64, 128) if D <= w)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return dp, 16 if D % 4 == 0 and aligned else 4


def _sdpa(q, k, v, mode):
    """The library's causal/full attention on 4-D views of the same fp32
    tensors: o / l, not (o, m, l)."""
    q4, k4, v4 = q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0)
    return F.scaled_dot_product_attention(q4, k4, v4, scale=1.0,
                                          is_causal=mode == 1)[0]


def _sdpa_backend(q, k, v, mode):
    q4, k4, v4 = q.unsqueeze(0), k.unsqueeze(0), v.unsqueeze(0)
    return SDPBackend(torch._fused_sdp_choice(
        q4, k4, v4, None, 0.0, mode == 1, scale=1.0)).name


# (name, BH, Sq, Sk, D, checks, timed): a check "a>b" folds mode a with
# the plain fold first, then holds mode b of the kernel against the plain
# fold on that; "fresh2" is mode 2 on fresh accumulators. Timed modes are
# timed on the accumulators of their check.
_b = 2  # entry()'s batch
FOLD_SHAPES = [
    ("entry", _b * CONFIG.n_heads, CONFIG.seq, CONFIG.seq, CONFIG.d_head,
     ["0", "1"], ["0", "1"]),
    ("batch64", 64 * CONFIG.n_heads, CONFIG.seq, CONFIG.seq, CONFIG.d_head,
     ["0", "1"], ["0", "1"]),
    ("aligned", 32, 1024, 1024, 128, ["0", "1", "1>2", "1>0"],
     ["0", "1", "1>2"]),
    ("ragged", 3, 100, 260, 40, ["0", "1", "fresh2"], ["0", "1"]),
    ("ring", 32, 256, 256, 64, ["0", "1", "1>2"], ["0", "1", "1>2"]),
    # edge shapes: every head-width instantiation with both copy widths
    ("d24", 2, 70, 90, 24, ["0", "1"], []),
    ("d30", 2, 70, 90, 30, ["0", "1"], []),
    ("d1", 2, 33, 47, 1, ["0", "1"], []),
    ("d16_offset", 2, 64, 64, 16, ["0", "1"], []),
    ("d37", 2, 65, 129, 37, ["0", "1"], []),
    ("d127", 2, 80, 100, 127, ["0", "1"], []),
    ("sq1", 4, 1, 200, 128, ["0", "1"], []),
    ("sk_lt_sq", 3, 130, 20, 32, ["0", "1", "1>2"], []),
]


def _edge_inputs(name, BH, Sq, Sk, D, seed):
    q, k, v, fresh = _fold_inputs(BH, Sq, Sk, D, seed)
    if name.endswith("_offset"):
        # contiguous tensors one float past a 16-byte boundary: the
        # kernel takes its 4-byte copies
        def off(t):
            buf = torch.empty(t.numel() + 1, device="cuda")
            out = buf[1:].view(t.shape)
            out.copy_(t)
            return out
        q, k, v = off(q), off(k), off(v)
    return q, k, v, fresh


def phase_kernels() -> tuple:
    """flash_fold against _fold_torch. Tolerances: o atol = rtol = 1e-4,
    m and l 1e-5 — the kernel sums in another order (online over 32-row
    K tiles, 3xTF32 products) than the one-shot plain fold."""
    floor_x = torch.zeros(1, device="cuda")
    launch_floor_ms = device_ms(lambda: floor_x.add_(1.0))
    phase("kernels", f"launch floor (one 1-element torch op, device time): "
          f"{launch_floor_ms:.4f} ms")
    out, checked, covered = {}, [], set()
    for si, (name, BH, Sq, Sk, D, checks, timed) in enumerate(FOLD_SHAPES):
        q, k, v, fresh = _edge_inputs(name, BH, Sq, Sk, D, seed=100 + si)
        inst = _instantiation(q, k, v)
        covered.add(inst)
        accs = {}
        for check_spec in checks:
            spec = check_spec
            acc, label = fresh, f"mode {spec}"
            if ">" in spec:            # a first fold (plain), then this one
                first, spec = spec.split(">")
                acc = FA._fold_torch(q, k, v, *fresh, int(first))
                label = f"mode {spec} after mode {first}"
            elif spec == "fresh2":
                label = "mode 2 on fresh accumulators"
            mode = 2 if spec == "fresh2" else int(spec)
            got = FA.flash_block_update(q, k, v, *acc, mode)
            want = FA._fold_torch(q, k, v, *acc, mode)
            torch.cuda.synchronize()
            e = [_err_share(got[0], want[0], 1e-4, 1e-4, f"{name} {label} o"),
                 _err_share(got[1], want[1], 1e-5, 1e-5, f"{name} {label} m"),
                 _err_share(got[2], want[2], 1e-5, 1e-5, f"{name} {label} l")]
            if spec == "fresh2":
                check(bool((got[2] == float(Sk)).all()),
                      f"{name}: mode 2 on fresh accumulators must give "
                      f"l == Sk")
            chk = {"shape": [BH, Sq, Sk, D], "mode": check_spec,
                   "dp": inst[0], "copy_bytes": inst[1],
                   "err": dict(zip("oml", (x[0] for x in e))),
                   "tol_share": dict(zip("oml", (x[1] for x in e)))}
            errs = (f"max abs err o {e[0][0]:.3g} m {e[1][0]:.3g} l "
                    f"{e[2][0]:.3g}; tolerance used o {e[0][1]:.1%} m "
                    f"{e[1][1]:.1%} l {e[2][1]:.1%}")
            checked.append(chk)
            accs[check_spec] = (acc, mode, got, chk, errs)
            phase("kernels", f"flash_fold {name} (BH={BH}, Sq={Sq}, Sk={Sk},"
                  f" D={D}; DP={inst[0]}, {inst[1]}-byte copies) {label}: "
                  f"{errs}")
        for spec in timed:
            acc, mode, got, chk, errs = accs[spec]
            fresh_heads = int((acc[1] <= -1e30).any(dim=1).sum())
            ms = device_ms(lambda: FA.flash_block_update(q, k, v, *acc, mode))
            plain_ms = device_ms(lambda: FA._fold_torch(q, k, v, *acc, mode))
            bound_ms, bound_by, fp32_ms = _fold_bound(BH, Sq, Sk, D, mode,
                                                      fresh_heads)
            rec = {**chk, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bound_fp32_ms": fp32_ms,
                   "launch_floor_ms": launch_floor_ms,
                   "max_abs_err": max(chk["err"].values()),
                   "library_ms": None, "library_backend": None}
            lib = ""
            if spec in ("0", "1"):     # fresh accumulators: the main path's use
                rec["library_backend"] = _sdpa_backend(q, k, v, mode)
                rec["library_ms"] = device_ms(lambda: _sdpa(q, k, v, mode))
                diff = (_sdpa(q, k, v, mode) - got[0] / got[2][..., None]
                        ).abs().max().item()
                lib = (f", library {rec['library_ms']:.4f} ms (SDPA, "
                       f"{rec['library_backend']}, 4-D views; computes o/l, "
                       f"not (o, m, l); max |SDPA - o/l| {diff:.3g})")
            out[(name, spec)] = rec
            phase("kernels", f"flash_fold {name} mode {spec}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.6f} ms ({bound_by}), kernel/bound "
                  f"{ms / bound_ms:.1f}x, bound_fp32 {fp32_ms:.6f} ms, "
                  f"launch floor {launch_floor_ms:.4f} ms; {errs}{lib}")
    want = {(dp, w) for dp in (16, 32, 64, 128) for w in (16, 4)}
    check(covered == want, f"instantiations checked {sorted(covered)}, "
          f"want {sorted(want)}")
    return out, checked


# -- phase 23 ----------------------------------------------------------
# a bucket of the DDP cell: GPT-2 medium's gradients in DDP's reverse
# order at its 25 MiB cap (layer 23's attention, then layer 22's
# LayerNorms and MLP), per-rank widths
FOLD_BUCKET = [1024, 1024, 1024, 1024 * 1024, 3072, 1024 * 3072, 1024, 1024,
               1024, 1024 * 4096]


def _flush_before(parts):
    """The flush as it ran before the fold: pack, the direct allreduce
    (sum over the rank rows, expanded to every row), unpack."""
    flat = torch.cat(parts, dim=1)
    red = torch.sum(flat, dim=0, dtype=flat.dtype).expand(flat.shape)
    fused = red.contiguous()
    outs, off = [], 0
    for p in parts:
        outs.append(fused[:, off:off + p.shape[1]].contiguous())
        off += p.shape[1]
    return outs


def phase_bucketfold() -> dict:
    """The fold against the plain fold, bit for bit (both sum the rows in
    rank order in float32), and its device time beside its bound."""
    n = N_RANKS
    g = torch.Generator(device="cuda").manual_seed(23)
    parts = [torch.randn((n, w), device="cuda", generator=g)
             for w in FOLD_BUCKET]
    table = BF.Table(parts, "sum")
    out = torch.empty(n * table.total, device="cuda")
    before = BF.launches
    BF.fold(parts, table, out)
    want = BF.fold_plain(parts, "sum", torch.empty_like(out))
    torch.cuda.synchronize()
    check(BF.launches == before + 1, "the fold did not launch its kernel")
    check(torch.equal(out, want), f"bucket_fold differs from the plain "
          f"fold: max abs {(out - want).abs().max().item():.3g}")
    old = torch.cat(_flush_before(parts), dim=1).reshape(-1)
    ref = torch.cat([v.reshape(n, -1) for v in table.views(out)], dim=1)
    diff = (ref.reshape(-1) - old).abs().max().item()
    check(diff <= 1e-4, f"bucket_fold against the old flush: {diff:.3g}")
    nbytes = BF.fold_bytes(n, table.total, 4)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ms = device_ms(lambda: BF.fold(parts, table, out))
    plain_ms = device_ms(lambda: BF.fold_plain(parts, "sum", want))
    old_ms = device_ms(lambda: _flush_before(parts))
    rec = {"name": "bucket_fold", "members": len(parts), "rows": n,
           "bytes_per_rank": 4 * table.total, "bytes": nbytes, "ms": ms,
           "plain_ms": plain_ms, "before_ms": old_ms, "bound_ms": bound_ms,
           "hbm_share": bound_ms / ms, "max_abs_err": 0.0,
           "against_before": diff}
    phase("bucketfold", f"bucket_fold ({len(parts)} members, "
          f"{4 * table.total} B a rank, {n} rows, {table.blocks} blocks): "
          f"bit for bit against the plain fold; |fold - old flush| "
          f"{diff:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, old "
          f"pack + direct allreduce + unpack {old_ms:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s); "
          f"{nbytes / ms / 1e6:.1f} GB/s, {bound_ms / ms:.1%} of HBM")
    return rec


# -- phase 4 -----------------------------------------------------------
def _close(got, want, rtol, atol, what):
    ok = np.allclose(got, want, rtol=rtol, atol=atol)
    check(ok, f"{what}: max abs err "
          f"{np.max(np.abs(got.astype(np.float64) - want)):.3g}")


def phase_collectives(w) -> None:
    """Float SUM/PROD/scan results: rtol 1e-5 (atol 1e-5 for sums near
    zero) — the device sums 8 rows in another order than numpy. MAX, MIN,
    data movement and int32 are exact."""
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((n, LOCAL_ELEMS), device="cuda", generator=g)
    y = torch.randn((n, n, LOCAL_ELEMS // n), device="cuda", generator=g)
    xp = 1 + 1e-3 * torch.randn((n, LOCAL_ELEMS), device="cuda", generator=g)
    xi = torch.randint(-1000, 1000, (n, LOCAL_ELEMS), device="cuda",
                       dtype=torch.int32, generator=g)
    xh, yh, xph, xih = (t.cpu().numpy() for t in (x, y, xp, xi))
    local_bytes = LOCAL_ELEMS * 4
    local_mib = local_bytes / 2 ** 20

    def run(name, fn, pick, read=x.numel() * 4):
        """Time ``fn`` and return its result on the host. The rate is the
        least device traffic of the call — the input it must read
        (``read``: the stacked input, or root's row alone) read once and
        the stacked output written once — over its time; all 8 ranks
        share one card's memory. ``auto``'s pick for the call's ``pick``
        = (func, buffer, op, root) stands beside it."""
        func, buf, op, root = pick
        alg = w._coll(func).selected(func, buf, op, root)
        if (func, alg) in (("reduce", "alias"), ("gather", "allgather")):
            to = "allreduce" if func == "reduce" else "allgather"
            alg += f" -> {to} {w._coll(to).selected(to, buf, op)}"
        ms = host_ms(fn)
        res = fn()
        moved = read + res.numel() * res.element_size()
        phase("collectives", f"{name} (auto: {alg}): {ms:.3f} ms for "
              f"{local_mib:.0f} MiB per rank; {moved / 1e6:.0f} MB in+out, "
              f"{moved / ms / 1e6:.1f} GB/s "
              f"({moved / ms / 1e9 / (HBM_BYTES_PER_S / 1e12):.1%} of "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        COLL_MS[("p4", name)] = ms
        return res.cpu().numpy()

    r = run("allreduce SUM f32", lambda: w.allreduce(x, MPI.SUM),
            ("allreduce", x, MPI.SUM, None))
    _close(r, np.broadcast_to(xh.sum(0), xh.shape), 1e-5, 1e-5,
           "allreduce SUM")
    r = run("allreduce MAX f32", lambda: w.allreduce(x, MPI.MAX),
            ("allreduce", x, MPI.MAX, None))
    check(np.array_equal(r, np.broadcast_to(xh.max(0), xh.shape)),
          "allreduce MAX")
    r = run("allreduce PROD f32", lambda: w.allreduce(xp, MPI.PROD),
            ("allreduce", xp, MPI.PROD, None))
    _close(r, np.broadcast_to(xph.prod(0), xph.shape), 1e-5, 0,
           "allreduce PROD")
    r = run("allreduce SUM i32", lambda: w.allreduce(xi, MPI.SUM),
            ("allreduce", xi, MPI.SUM, None))
    check(np.array_equal(r, np.broadcast_to(xih.sum(0, dtype=np.int32),
                                            xih.shape)), "allreduce i32")
    r = run("reduce MIN root 2", lambda: w.reduce(x, MPI.MIN, root=2),
            ("reduce", x, MPI.MIN, 2))
    check(np.array_equal(r[2], xh.min(0)), "reduce MIN")
    r = run("bcast root 3", lambda: w.bcast(x, root=3),
            ("bcast", x, None, 3), read=local_bytes)
    check(np.array_equal(r, np.broadcast_to(xh[3], xh.shape)), "bcast")
    r = run("allgather", lambda: w.allgather(x),
            ("allgather", x, None, None))
    check(r.shape == (n, n, LOCAL_ELEMS), "allgather shape")
    check(all(np.array_equal(r[i], xh) for i in range(n)), "allgather")
    r = run("gather root 1", lambda: w.gather(x, root=1),
            ("gather", x, None, 1))
    check(np.array_equal(r[1], xh), "gather")
    del r
    r = run("scatter root 5", lambda: w.scatter(y, root=5),
            ("scatter", y, None, 5),
            read=local_bytes)
    check(np.array_equal(r, yh[5]), "scatter")
    r = run("alltoall", lambda: w.alltoall(y),
            ("alltoall", y, None, None))
    check(np.array_equal(r, np.swapaxes(yh, 0, 1)), "alltoall")
    r = run("reduce_scatter_block SUM",
            lambda: w.reduce_scatter_block(y, MPI.SUM),
            ("reduce_scatter_block", y, MPI.SUM, None))
    _close(r, yh.sum(0), 1e-5, 1e-5, "reduce_scatter_block")
    r = run("scan SUM", lambda: w.scan(x, MPI.SUM),
            ("scan", x, MPI.SUM, None))
    pre = np.cumsum(xh, axis=0)
    _close(r, pre, 1e-5, 1e-5, "scan")
    r = run("exscan SUM", lambda: w.exscan(x, MPI.SUM),
            ("exscan", x, MPI.SUM, None))
    _close(r[1:], pre[:-1], 1e-5, 1e-5, "exscan")
    check(np.array_equal(r[0], xh[0]), "exscan row 0")
    del r, pre
    bar_ms = COLL_MS[("p4", "barrier")] = host_ms(w.barrier, iters=20)
    phase("collectives", f"barrier (auto: "
          f"{w._coll('barrier').selected('barrier')}): {bar_ms:.4f} ms")

    evens, odds = w.split([i % 2 for i in range(n)])[0:2]
    check(evens.size == n // 2 and odds.size == n // 2, "split sizes")
    sub = evens.allreduce(evens.stack([x[i] for i in range(0, n, 2)]),
                          MPI.SUM).cpu().numpy()
    _close(sub, np.broadcast_to(xh[0::2].sum(0), sub.shape), 1e-5, 1e-5,
           "split allreduce")
    phase("collectives", f"split even/odd: {evens.name} size {evens.size},"
          f" allreduce SUM on it checked")

    w.set_errhandler(MPI.ERRORS_RETURN)
    try:
        w.bcast(x, root=n)
        raise RuntimeError("chip_smoke check failed: bad root accepted")
    except MPI.MPIError as e:
        phase("collectives", f"ERRORS_RETURN bad root raised: {e}")

    small = w.alloc((2,), dtype=torch.float32, fill=1.0)   # 8 B per rank
    before = len(w._subeager)
    calls = 2000
    w.allreduce(small, MPI.SUM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        res = w.allreduce(small, MPI.SUM)
    torch.cuda.synchronize()
    us = (time.perf_counter() - t0) / calls * 1e6
    check(len(w._subeager) == before + 1, "8 B allreduce missed _subeager")
    check(bool((res == n).all()), "8 B allreduce value")
    phase("collectives", f"8 B allreduce (8 ranks, _subeager path): "
          f"{us:.2f} us/call")
    w.set_errhandler(MPI.ERRORS_ARE_FATAL)


# -- phase 5 -----------------------------------------------------------
def phase_flagship() -> int:
    fn, (params, tokens) = entry()
    g = torch.Generator(device="cuda").manual_seed(11)
    tokens64 = torch.randint(0, CONFIG.vocab, (64, CONFIG.seq),
                             device="cuda", generator=g)
    L = CONFIG.n_layers

    FA.launches = 0                     # the main path starts here
    with torch.no_grad():
        logits = fn(params, tokens)
        torch.cuda.synchronize()
        check(FA.launches == L, f"{FA.launches} kernel launches in one "
              f"forward, want {L}")
        logits64 = fn(params, tokens64)
        torch.cuda.synchronize()
    launches = FA.launches              # ... and ends here
    check(launches == 2 * L, f"{launches} launches in two forwards")

    # the same forward through the plain fold: with autograd on,
    # attention takes the training path, _fold_torch
    with torch.enable_grad():
        ref = fn(params, tokens).detach()
        ref64 = fn(params, tokens64).detach()
    check(FA.launches == launches, "the plain-fold forward launched")
    for name, got, want, B in (("batch 2", logits, ref, 2),
                               ("batch 64", logits64, ref64, 64)):
        check(tuple(got.shape) == (B, CONFIG.seq, CONFIG.vocab),
              f"{name} logits shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name} non-finite logits")
        err = (got - want).abs().max().item()
        check(err <= 2e-2, f"{name} logits vs plain fold: {err:.3g}")
        phase("flagship", f"entry forward {name}: logits {tuple(got.shape)}"
              f" {got.dtype}, max abs err vs plain fold {err:.3g} "
              f"(atol 2e-2, bf16)")
    # an independent formulation of the same attention: dense softmax
    with torch.no_grad():
        dense64 = T.forward(params, tokens64,
                            dataclasses.replace(CONFIG, use_flash=False))
    err = (logits64 - dense64).abs().max().item()
    check(err <= 5e-2, f"batch 64 logits vs dense attention: {err:.3g}")
    phase("flagship", f"entry forward batch 64 against dense softmax "
          f"attention: max abs err {err:.3g} (atol 5e-2: bf16 "
          f"probabilities and outputs)")

    with torch.no_grad():
        for name, tok in (("batch 2", tokens), ("batch 64", tokens64)):
            k_ms = host_ms(lambda: fn(params, tok), iters=20, warmup=3)
            with torch.enable_grad():
                p_ms = host_ms(lambda: fn(params, tok), iters=20, warmup=3)
            phase("flagship", f"forward {name}: {k_ms:.3f} ms with the "
                  f"kernel, {p_ms:.3f} ms with the plain fold (host clock,"
                  f" synchronised)")
    return launches


# -- phase 6 -----------------------------------------------------------
def _device_share(fn, iters: int = 3) -> str:
    """Kernels, device time and the device's busy share of the wall time
    per ``fn()`` call, from ``torch.profiler`` (CUPTI) over ``iters``
    calls after one warm-up; "not measured" when the profiler records no
    device time. The profiler's own host cost lengthens the wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / iters
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev) / iters
    if dev_us <= 0:
        return "device time not measured (the profiler recorded none)"
    kernels = sum(e.count for e in dev) / iters
    return (f"{kernels:.0f} device ops, {dev_us / 1e3:.3f} ms device time "
            f"in {wall_us / 1e3:.3f} ms wall per step under the profiler: "
            f"device busy {dev_us / wall_us:.1%}, idle "
            f"{1 - dev_us / wall_us:.1%}")


def _losses_close(got, want, what):
    """The JAX dryrun's tolerances: step 1 rtol 1e-4 / atol 1e-5, step 2
    rtol 2e-3 / atol 1e-4."""
    for i, (a, b, rtol, atol) in enumerate(zip(got, want, (1e-4, 2e-3),
                                               (1e-5, 1e-4))):
        check(abs(a - b) <= atol + rtol * abs(b),
              f"{what} step-{i + 1} loss {a} != {b}")


def phase_train(smi: str) -> None:
    """The training path on the card: no kernel launches (the train
    steps need autograd, which the flash kernel lacks), fp32 products."""
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "the train checks assume fp32 products (allow_tf32 is on)")
    dev = torch.device("cuda", 0)
    before = FA.launches

    # (1) the JAX dryrun's step, dp=2 against dp=1 and Ulysses, on the
    # card; the same step on the CPU must give the same losses
    res = E.dryrun_multichip(8)
    tok_dry = np.random.default_rng(0).integers(
        0, E.DRYRUN_CONFIG.vocab, (8, E.DRYRUN_CONFIG.seq + 1))
    cpu = E._run_flagship(2, 1, 2, 2, tok_dry, device="cpu")
    _losses_close(res["dp1"], cpu, "card vs CPU")
    phase("train", f"dryrun losses: card dp=1 {res['dp1']}, dp=2 "
          f"{res['dp2']}, CPU dp=1 {cpu}; Ulysses max abs err "
          f"{res['ulysses_err']:.3g}")
    _, _, p, step = E.flagship_step(2, 1, 2, 2, tok_dry, device=dev)
    dry_ms = host_ms(lambda: step(p), iters=10, warmup=2)

    # (2) the combined step at the flagship's full width, float32, MoE
    cfg = dataclasses.replace(CONFIG, dtype=torch.float32, moe=True,
                              moe_experts=2)
    tok = np.random.default_rng(1).integers(0, cfg.vocab, (8, cfg.seq + 1))
    torch.cuda.reset_peak_memory_stats()
    mesh, specs, p, step = E.flagship_step(2, 1, 2, 2, tok, cfg=cfg,
                                           device=dev)
    for i in range(2):
        p, loss = step(p)
        loss = float(mesh.unshard(loss, P()))
        div = mesh.divergence(p, specs)
        check(np.isfinite(loss), f"full-width step {i + 1}: loss {loss}")
        check(div <= 1e-6, f"full-width step {i + 1}: replicated leaves "
              f"differ by {div:.3g}")
        check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(p)),
              f"full-width step {i + 1}: non-finite params")
        phase("train", f"full-width pp=2 x dp=1 x tp=2 x sp=2 step "
              f"{i + 1}: loss {loss:.6f}, largest divergence of a "
              f"replicated leaf across its ranks {div:.3g} (limit 1e-6)")
    peak = torch.cuda.max_memory_allocated()
    full_ms = host_ms(lambda: step(p), iters=10, warmup=2)

    # (3) the dense step on dp=2 x tp=2 x sp=2 against one device
    cfg_d = dataclasses.replace(cfg, moe=False, moe_experts=0)
    params = T.init_params(cfg_d, torch.Generator().manual_seed(0), dev)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (8, cfg.seq + 1))).to(dev)
    batch = (tok[:, :-1], tok[:, 1:])
    ref_p, ref_loss = T.sgd_train_step(params, batch, cfg_d, 1e-2)
    mesh = Mesh((2, 2, 2), ("dp", "tp", "sp"), dev)
    specs = E._param_specs(params)
    comms = [InGraphComm(a, 2, mesh) for a in ("dp", "tp", "sp")]
    sharded = mesh.shard(params, specs)
    sb = mesh.shard(batch, (P("dp", "sp"),) * 2)
    new_p, loss = T.sgd_train_step(sharded, sb, cfg_d, 1e-2, *comms)
    loss = float(mesh.unshard(loss, P()))
    check(abs(loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss)),
          f"8-rank dense loss {loss} != single-device {float(ref_loss)}")
    worst = 0.0
    for a, b in zip(tree_leaves(mesh.unshard(new_p, specs)),
                    tree_leaves(ref_p)):
        check(bool(torch.allclose(a, b, rtol=2e-4, atol=2e-6)),
              f"8-rank dense params differ from single-device by "
              f"{(a - b).abs().max().item():.3g}")
        worst = max(worst, (a - b).abs().max().item())
    phase("train", f"dense sgd_train_step dp=2 x tp=2 x sp=2 against one "
          f"device: loss {loss:.6f} vs {float(ref_loss):.6f}, params max "
          f"abs diff {worst:.3g} (loss rtol 1e-5; params rtol 2e-4 atol "
          f"2e-6)")
    one_ms = host_ms(lambda: T.sgd_train_step(params, batch, cfg_d, 1e-2),
                     iters=10, warmup=2)
    eight_ms = host_ms(lambda: T.sgd_train_step(sharded, sb, cfg_d, 1e-2,
                                                *comms), iters=10, warmup=2)

    phase("train", f"full-width MoE step, torch.profiler: "
          f"{_device_share(lambda: step(p))} | {smi}")
    dense = _device_share(lambda: T.sgd_train_step(params, batch, cfg_d,
                                                   1e-2))
    phase("train", f"full-width dense step, one device, torch.profiler: "
          f"{dense} | {smi}")
    launched = FA.launches - before
    check(launched == 0, f"{launched} kernel launches in training")
    for name, ms in (("dryrun pp=2 x dp=1 x tp=2 x sp=2 step", dry_ms),
                     ("full-width pp=2 x dp=1 x tp=2 x sp=2 MoE step",
                      full_ms),
                     ("full-width dense step, one device", one_ms),
                     ("full-width dense step, dp=2 x tp=2 x sp=2", eight_ms)):
        phase("train", f"{name}: {ms:.3f} ms per step (host clock, "
              f"synchronised, median of 10 after 2 warm-ups) | {smi}")
    phase("train", f"full-width MoE step peak memory: {peak} B "
          f"({peak / 2 ** 20:.1f} MiB, torch.cuda.max_memory_allocated) | "
          f"{smi}")
    phase("train", f"flash_fold launches across the train steps: "
          f"{launched} (training runs the plain fold)")


# -- phase 7 -----------------------------------------------------------
SMALL_ELEMS = 37               # per rank: not a multiple of the 8 ranks
SCHEDULE_SLOTS = ("iallreduce", "ibcast", "iallgather", "ibarrier")


def _inputs(n, elems, seed):
    """Float, PROD-safe float, int32 (N, elems) and (N, N, elems // N or
    elems) stacked inputs on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    chunk = elems // n if elems % n == 0 else elems
    return (torch.randn((n, elems), device="cuda", generator=g),
            1 + 1e-3 * torch.randn((n, elems), device="cuda", generator=g),
            torch.randint(-1000, 1000, (n, elems), device="cuda",
                          dtype=torch.int32, generator=g),
            torch.randn((n, n, chunk), device="cuda", generator=g))


def _held(name, got, want, rtol=None, atol=0.0, rows=slice(None)):
    """``got`` against ``want`` on the card: exact, or within rtol/atol."""
    got, want = got[rows], want[rows]
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} against "
          f"{tuple(want.shape)} {want.dtype}")
    ok = (torch.equal(got, want) if rtol is None else
          bool(torch.allclose(got, want, rtol=rtol, atol=atol)))
    err = (got.double() - want.double()).abs().max().item()
    check(ok, f"{name}: max abs err {err:.3g} against the blocking call")
    return err


def _i_entries(w, elems, seed) -> str:
    """Every i-entry against its blocking counterpart: float SUM/PROD
    rtol 1e-5 (atol 1e-5 for SUM, whose sums come near zero), the rest
    exact. Returns the largest float error."""
    n = w.size
    x, xp, xi, y = _inputs(n, elems, seed)
    S = MPI.SUM
    cases = [
        ("iallreduce SUM f32", lambda: w.iallreduce(x, S),
         lambda: w.allreduce(x, S), 1e-5, 1e-5, slice(None)),
        ("iallreduce MAX f32", lambda: w.iallreduce(x, MPI.MAX),
         lambda: w.allreduce(x, MPI.MAX), None, 0, slice(None)),
        ("iallreduce PROD f32", lambda: w.iallreduce(xp, MPI.PROD),
         lambda: w.allreduce(xp, MPI.PROD), 1e-5, 0, slice(None)),
        ("iallreduce SUM i32", lambda: w.iallreduce(xi, S),
         lambda: w.allreduce(xi, S), None, 0, slice(None)),
        ("ibcast root 3", lambda: w.ibcast(x, 3), lambda: w.bcast(x, 3),
         None, 0, slice(None)),
        ("ireduce MIN root 2", lambda: w.ireduce(x, MPI.MIN, 2),
         lambda: w.reduce(x, MPI.MIN, 2), None, 0, 2),
        ("iallgather", lambda: w.iallgather(x), lambda: w.allgather(x),
         None, 0, slice(None)),
        ("igather root 1", lambda: w.igather(x, 1), lambda: w.gather(x, 1),
         None, 0, 1),
        ("iscatter root 5", lambda: w.iscatter(y, 5),
         lambda: w.scatter(y, 5), None, 0, slice(None)),
        ("ialltoall", lambda: w.ialltoall(y), lambda: w.alltoall(y),
         None, 0, slice(None)),
        ("ireduce_scatter_block SUM", lambda: w.ireduce_scatter_block(y, S),
         lambda: w.reduce_scatter_block(y, S), 1e-5, 1e-5, slice(None)),
        ("iscan SUM", lambda: w.iscan(x, S), lambda: w.scan(x, S), 1e-5,
         1e-5, slice(None)),
        ("iexscan SUM", lambda: w.iexscan(x, S), lambda: w.exscan(x, S),
         1e-5, 1e-5, slice(1, None)),
    ]
    worst, rounds = 0.0, {}
    for name, nb, blocking, rtol, atol, rows in cases:
        req = nb()
        if isinstance(req, ScheduleRequest):
            rounds[name.split()[0]] = req.rounds_left
        err = _held(f"{name} ({elems}/rank)", req.get(), blocking(), rtol,
                    atol, rows)
        check(req.test()[0], f"{name}: test() after get() is False")
        if rtol is not None:
            worst = max(worst, err)
        del req
    w.ibarrier().wait()
    return (f"{len(cases)} entries and ibarrier held; largest float SUM/"
            f"PROD error {worst:.3g}; nbc schedule rounds {rounds}")


def phase_nonblocking_journey(w, smi: str) -> None:
    """(1) i-collectives, (2) persistent plans, (3) bucket fusion."""
    n = w.size
    winners = {s: w._coll_winners.get(s) for s in SCHEDULE_SLOTS}
    check(set(winners.values()) == {"nbc"}, f"schedule slots: {winners}")
    phase("nonblocking", f"schedule slot winners: {winners}")

    # (1) every i-entry at 37 elements and at 32 MB per rank
    x = torch.randn((n, SMALL_ELEMS), device="cuda")
    probes = {"iallreduce": w.iallreduce(x), "ibcast": w.ibcast(x, 0),
              "iallgather": w.iallgather(x), "ibarrier": w.ibarrier()}
    rounds = {k: r.rounds_left for k, r in probes.items()}
    want = {"iallreduce": 2 * (n - 1), "ibcast": math.ceil(math.log2(n)),
            "iallgather": n - 1, "ibarrier": math.ceil(math.log2(n))}
    check(rounds == want, f"schedule rounds {rounds}, want {want}")
    MPI.Waitall(list(probes.values()))
    phase("nonblocking", f"rounds_left before the first test() at "
          f"{SMALL_ELEMS} elements per rank: {rounds} (ring allreduce "
          f"2(N-1) = {2 * (n - 1)})")
    for elems in (SMALL_ELEMS, LOCAL_ELEMS):
        phase("nonblocking", f"i-entries at {elems} elements per rank: "
              f"{_i_entries(w, elems, seed=20 + elems % 97)}")

    big = torch.randn((n, LOCAL_ELEMS), device="cuda")
    host_us, after = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        req = w.iallreduce(big, MPI.SUM)
        req.test()                          # dispatches its one round
        host_us.append((time.perf_counter() - t0) * 1e6)
        after.append(req.test()[0])
        req.wait()
    reqs = []

    def dispatch():
        r = w.iallreduce(big, MPI.SUM)
        r.test()
        reqs.append(r)
    dev = device_ms(dispatch, iters=10, warmup=2)
    MPI.Waitall(reqs)
    phase("nonblocking", f"256 MB stacked iallreduce (fused round): "
          f"dispatch {statistics.median(host_us):.1f} us on the host "
          f"(median of 10), {dev:.4f} ms on the device (CUDA events); "
          f"test() right after the dispatch: {after[0]} (True in "
          f"{sum(after)} of 10) | {smi}")

    # (2) persistent plans at 32 MB per rank
    s0 = pvar.pvar_read("coll_persistent_starts")
    buf = big.clone()
    req = w.allreduce_init(buf, MPI.SUM)
    check(req.plan.algorithm == "direct" and req.plan.codec is None,
          f"plan {req.plan.algorithm} {req.plan.codec}")
    for i in range(10):
        buf.mul_(0.5).add_(float(i))        # Start reads the contents
        req.start()
        _held(f"allreduce_init start {i + 1}", req.get(),
              w.allreduce(buf, MPI.SUM))
    y = torch.randn((n, n, LOCAL_ELEMS // n), device="cuda")
    for name, init, blocking in (
            ("bcast_init", lambda: w.bcast_init(buf, 6),
             lambda: w.bcast(buf, 6)),
            ("allgather_init", lambda: w.allgather_init(buf),
             lambda: w.allgather(buf)),
            ("reduce_scatter_block_init",
             lambda: w.reduce_scatter_block_init(y, MPI.SUM),
             lambda: w.reduce_scatter_block(y, MPI.SUM))):
        r = init()
        r.start()
        _held(name, r.get(), blocking())
        del r
    r = w.barrier_init()
    r.start()
    r.wait()
    starts = pvar.pvar_read("coll_persistent_starts") - s0
    check(starts == 14, f"coll_persistent_starts moved {starts}, want 14")
    phase("nonblocking", f"persistent plans at 32 MB per rank: "
          f"allreduce_init started 10 times over a buffer changed in "
          f"place, each equal to the blocking allreduce of the current "
          f"contents; bcast/allgather/reduce_scatter_block/barrier_init "
          f"once each; coll_persistent_starts +{starts}")
    del buf, y, big

    small = w.alloc((2,), dtype=torch.float32, fill=1.0)   # 8 B per rank
    preq = w.allreduce_init(small, MPI.SUM)
    calls = 2000

    def per_call(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    def start_wait():
        preq.start()
        preq.wait()
    p_us = per_call(start_wait)
    b_us = per_call(lambda: w.allreduce(small, MPI.SUM))
    check(bool((preq.get() == n).all()), "8 B persistent allreduce value")
    phase("nonblocking", f"8 B persistent allreduce Start+Wait "
          f"{p_us:.2f} us/call (the wait synchronizes on its event), "
          f"8 B blocking allreduce {b_us:.2f} us/call (host clock, "
          f"{calls} calls) | {smi}")

    # (3) bucket fusion over the flagship's gradient-shaped leaves
    cfg = dataclasses.replace(CONFIG, dtype=torch.float32)
    shapes = [tuple(t.shape) for t in tree_leaves(
        T.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))]
    g = torch.Generator(device="cuda").manual_seed(9)
    leaves = [torch.randint(-8, 8, (n,) + s, device="cuda",
                            generator=g).float() for s in shapes]
    plans = [w.allreduce_init(t, MPI.SUM) for t in leaves]
    results = {}
    for on in (True, False):
        var.var_set("mpi_base_bucket", on)
        f0 = persistent.counters()["coll_bucket_flushes"]
        MPI.Startall(plans)
        results[on] = [r.get() for r in plans]
        results[f"flushes {on}"] = (persistent.counters()
                                    ["coll_bucket_flushes"] - f0)
    same = all(torch.equal(a, b)
               for a, b in zip(results[True], results[False]))
    check(same, "bucket on and off disagree at integer-valued inputs")
    per_rank = sum(t.nbytes for t in leaves) // n
    phase("nonblocking", f"Startall over {len(plans)} gradient-shaped "
          f"leaves ({per_rank} B per rank): bucket on "
          f"{results['flushes True']} fused flushes "
          f"(mpi_base_bucket_bytes {persistent.bucket_bytes()}), bucket "
          f"off {len(plans)} allreduces and {results['flushes False']} "
          f"flushes; results byte-identical")

    def startall_get():
        MPI.Startall(plans)
        for r in plans:
            r.get()

    def startall_device_ms():
        """Device time of the work one Startall queues: CUDA events
        around the Startall alone, the gets after the end event."""
        times = []
        for _ in range(20):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(2_000_000)
            start.record()
            MPI.Startall(plans)
            end.record()
            for r in plans:
                r.get()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)
    turns = []
    for on in (True, False, False, True):       # in turns
        var.var_set("mpi_base_bucket", on)
        turns.append((on, host_ms(startall_get, iters=20, warmup=3),
                      startall_device_ms()))
    var.var_set("mpi_base_bucket", False)
    phase("nonblocking", f"Startall + get over the {len(plans)} leaves, "
          "in turns (host clock synchronised, median of 20; the device "
          "time of the Startall's work by CUDA events, median of 20): "
          + "; ".join(
              f"bucket {'on' if on else 'off'} {h:.3f} ms host, {d:.4f} "
              f"ms device" for on, h, d in turns) + f" | {smi}")


def _ddp_losses_close(got, want, what):
    """Step 1 rtol 1e-5; step 2 rtol 2e-3 / atol 1e-4 (the dryrun's)."""
    for i, (a, b, rtol, atol) in enumerate(zip(got, want, (1e-5, 2e-3),
                                               (0.0, 1e-4))):
        check(abs(a - b) <= atol + rtol * abs(b),
              f"{what} step-{i + 1} loss {a} != {b}")


def phase_ddp(w, smi: str) -> None:
    """(4) the DDP train step at the flagship's full width on dp=8."""
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "the train checks assume fp32 products (allow_tf32 is on)")
    dev = torch.device("cuda", 0)
    n = w.size
    before = FA.launches
    cfg = dataclasses.replace(CONFIG, dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    mesh = Mesh((n,), ("dp",), dev)
    specs = tree_map(lambda _: P(), params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2 * n, cfg.seq + 1)))
    batch = mesh.shard((tok[:, :-1], tok[:, 1:]), (P("dp"), P("dp")))
    dpc = InGraphComm("dp", n, mesh)
    start = mesh.shard(params, specs)

    def make(kind):
        """A step function for (a) bucket on, (b) bucket off, (c) the
        in-graph pmean; (a) and (b) own their BucketedGradSync."""
        if kind == "c":
            return lambda p: T.sgd_train_step(p, batch, cfg, 1e-2, dpc)
        sync = T.BucketedGradSync(w, start)
        return lambda p: T.sgd_train_step(p, batch, cfg, 1e-2, dpc,
                                          grad_sync=sync)

    runs, steps, bucket = {}, {}, {"a": True, "b": False, "c": False}
    for kind in ("a", "b", "c"):
        var.var_set("mpi_base_bucket", bucket[kind])
        step = steps[kind] = make(kind)
        if kind == "a":
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        p, losses, flushes = start, [], []
        for i in range(2):
            f0 = persistent.counters()["coll_bucket_flushes"]
            p, loss = step(p)
            flushes.append(persistent.counters()["coll_bucket_flushes"] - f0)
            losses.append(float(loss[0]))
            div = mesh.divergence(p, specs)
            check(np.isfinite(losses[-1]), f"DDP ({kind}) step {i + 1}: "
                  f"loss {losses[-1]}")
            check(div <= 1e-6, f"DDP ({kind}) step {i + 1}: replicated "
                  f"leaves differ by {div:.3g}")
            if kind == "a":
                peak = torch.cuda.max_memory_allocated()
            runs.setdefault(kind, {})[f"div{i + 1}"] = div
        runs[kind].update(params=p, losses=losses, flushes=flushes,
                          prof=_device_share(lambda: step(start)), ms=[])
    for kind in ("a", "b", "c", "c", "b", "a"):     # times in turns
        var.var_set("mpi_base_bucket", bucket[kind])
        runs[kind]["ms"].append(host_ms(lambda: steps[kind](start),
                                        iters=10, warmup=2))
    var.var_set("mpi_base_bucket", False)
    for kind in ("a", "b"):
        _ddp_losses_close(runs[kind]["losses"], runs["c"]["losses"],
                          f"DDP ({kind}) against the in-graph pmean")
    worst = 0.0
    for a, b in zip(tree_leaves(runs["a"]["params"]),
                    tree_leaves(runs["c"]["params"])):
        check(bool(torch.allclose(a, b, rtol=2e-4, atol=2e-6)),
              f"DDP (a) params differ from (c) by "
              f"{(a - b).abs().max().item():.3g}")
        worst = max(worst, (a - b).abs().max().item())
    launched = FA.launches - before
    check(launched == 0, f"{launched} kernel launches in the DDP steps")
    names = {"a": "BucketedGradSync, bucket on",
             "b": "BucketedGradSync, bucket off",
             "c": "in-graph dp pmean"}
    for kind, r in runs.items():
        phase("ddp", f"({kind}) {names[kind]}: losses "
              f"{r['losses'][0]:.6f}, {r['losses'][1]:.6f}; largest "
              f"divergence of a replicated leaf {r['div1']:.3g}, "
              f"{r['div2']:.3g} (limit 1e-6); fused flushes per step "
              f"{r['flushes']}")
    phase("ddp", f"(a) against (c): params max abs diff {worst:.3g} "
          f"after 2 steps (rtol 2e-4, atol 2e-6); losses within step 1 "
          f"rtol 1e-5, step 2 rtol 2e-3 / atol 1e-4")
    for kind, r in runs.items():
        phase("ddp", f"({kind}) {names[kind]}: "
              f"{' and '.join(f'{ms:.3f}' for ms in r['ms'])} ms per step "
              f"(timed in turns a b c c b a; host clock, synchronised, "
              f"median of 10 after 2 warm-ups); torch.profiler: "
              f"{r['prof']} | {smi}")
    phase("ddp", f"(a) peak memory: {peak} B ({peak / 2 ** 20:.1f} MiB, "
          f"torch.cuda.max_memory_allocated), of which {base} B "
          f"({base / 2 ** 20:.1f} MiB) was allocated before its first "
          f"step | {smi}")
    phase("ddp", f"flash_fold launches across the DDP steps: {launched}")


# -- phase 8 -----------------------------------------------------------
ALG_CHECK_ELEMS = 37           # per rank: no schedule's chunking divides it
ALG_CHECK_SIZES = (8, 3, 5, 6)
ALG_FUNCS = ("allreduce", "reduce", "bcast", "allgather", "gather",
             "scatter", "alltoall", "reduce_scatter_block", "scan", "exscan")
ALG_REDUCING = ("allreduce", "reduce", "reduce_scatter_block", "scan",
                "exscan")
ALG_ROOTED = ("reduce", "bcast", "gather", "scatter")
# The lowering each schedule is held against: reduce's and gather's
# symmetric aliases, every other collective's direct lowering.
ALG_BASELINE = {"reduce": "alias", "gather": "allgather"}
# Schedules whose every combine is op.fn on the same operands in the same
# order on any device: the card's result equals the CPU port's bit for bit.
ALG_BITWISE = {"ring", "ring_segmented", "recursive_doubling",
               "in_order_binary", "knomial", "recursive_halving",
               "butterfly"}


def _alg_var(func: str) -> str:
    return f"coll_torch_{'scan' if func == 'exscan' else func}_algorithm"


def _alg_expected(func: str, alg: str, n: int, op) -> str:
    """What the reference's rules run for ``alg`` forced on ``n`` ranks
    with ``op``: coll/decision's structural demotions, then each
    collective's own (coll/xla.py:1209-1658)."""
    f = "scan" if func == "exscan" else func
    if (alg in decision.REORDERING and op is not None and not op.commute
            and (f, alg) not in decision.ORDER_PRESERVING):
        alg = "direct"
    elif (alg in decision.POW2_ONLY and n & (n - 1)
          and (f, alg) not in decision.POW2_EXEMPT):
        alg = "direct"
    elif alg in decision.EVEN_ONLY and n % 2:
        alg = "direct"
    elif alg == "two_procs" and n != 2:
        alg = "direct"
    elif (alg in ("rabenseifner", "rabenseifner_root")
          or (f, alg) == ("reduce_scatter_block", "hier")) \
            and op.xla_prim != "sum":
        alg = "direct"
    if f == "reduce" and alg not in ("knomial", "in_order_binary",
                                     "rabenseifner_root"):
        alg = "alias"
    return alg


def _alg_run(comm, func, x, op, root):
    """``func`` on ``comm`` from the numpy ``x``: (host result, the
    algorithm that ran)."""
    buf = comm.put(x)
    args = (buf,) + ((op,) if op is not None else ()) + \
        ((root,) if root is not None else ())
    y = getattr(comm, func)(*args)
    return y.cpu().numpy(), comm._coll(func).selected(func, buf, op, root)


def _alg_checks(card, cpu, ops) -> str:
    """Every (collective, algorithm, op) at 37 elements per rank on a
    card communicator: against the direct lowering on the card (data
    movement, MAX, int32 and the non-commutative op exact; float32 SUM
    and PROD rtol 1e-5, atol 1e-5), bit for bit against the same schedule
    on the CPU port where it combines with op.fn alone (and wherever the
    result is exact), and what ran against the reference's rules."""
    n = card.size
    root = n - 1
    cases = bitwise = 0
    worst = 0.0
    demoted = {}
    for fi, func in enumerate(ALG_FUNCS):
        name = _alg_var(func)
        f = "scan" if func == "exscan" else func
        lead = (n, n) if func in ("scatter", "alltoall",
                                  "reduce_scatter_block") else (n,)
        r = root if func in ALG_ROOTED else None
        kinds = ([("float32", "SUM"), ("float32", "PROD"),
                  ("float32", "MAX"), ("int32", "SUM"),
                  ("float32", "right_take")]
                 if func in ALG_REDUCING else [("float32", None)])
        for ki, (dtype, opname) in enumerate(kinds):
            op = ops[opname] if opname else None
            rng = np.random.default_rng(1000 * n + 10 * fi + ki)
            if dtype == "int32":
                x = rng.integers(-1000, 1000, lead + (ALG_CHECK_ELEMS,),
                                 dtype=np.int32)
            else:
                x = rng.standard_normal(lead + (ALG_CHECK_ELEMS,)) \
                    .astype(np.float32)
                if opname == "PROD":
                    x = (1 + 0.05 * x).astype(np.float32)
            var.var_set(name, ALG_BASELINE.get(f, "direct"))
            want, _ = _alg_run(card, func, x, op, r)
            for alg in ALGORITHMS[f][1:]:
                var.var_set(name, alg)
                got, ran = _alg_run(card, func, x, op, r)
                on_cpu, ran_cpu = _alg_run(cpu, func, x, op, r)
                what = f"{func} {alg} {opname} {dtype} n={n}"
                expected = _alg_expected(func, alg, n, op)
                check(ran == ran_cpu == expected,
                      f"{what}: ran {ran} (CPU {ran_cpu}), the "
                      f"reference's rules give {expected}")
                if ran != alg:
                    why = f" [{opname}]" if ran_cpu != _alg_expected(
                        func, alg, n, ops["SUM"]) else ""
                    demoted[f"{func} {alg}->{ran}{why}"] = None
                rows = root if func in ("reduce", "gather") else slice(None)
                g, w_ = got[rows], want[rows]
                check(g.shape == w_.shape and g.dtype == w_.dtype,
                      f"{what}: {g.shape} {g.dtype} against direct "
                      f"{w_.shape} {w_.dtype}")
                exact = opname in (None, "MAX", "right_take") \
                    or dtype == "int32"
                if exact:
                    check(np.array_equal(g, w_), f"{what}: differs from "
                          f"the direct lowering")
                else:
                    err = float(np.max(np.abs(g.astype(np.float64) - w_)))
                    worst = max(worst, err)
                    check(np.allclose(g, w_, rtol=1e-5, atol=1e-5),
                          f"{what}: max abs err {err:.3g} against direct")
                if exact or ran in ALG_BITWISE:
                    check(got.dtype == on_cpu.dtype and np.array_equal(
                        got.view(np.uint8), on_cpu.view(np.uint8)),
                        f"{what}: the card's bits differ from the CPU "
                        f"port's")
                    bitwise += 1
                cases += 1
            var.var_set(name, "auto")
    for alg in ALGORITHMS["barrier"][1:]:
        var.var_set("coll_torch_barrier_algorithm", alg)
        card.barrier()
        tok = card._coll("barrier")._ibarrier_arrays()[0].cpu()
        ref = cpu._coll("barrier")._ibarrier_arrays()[0]
        check(torch.equal(tok, ref) and bool((tok >= n).all()),
              f"barrier {alg} n={n}: token {tok.tolist()} against the "
              f"CPU port's {ref.tolist()}")
        check(card._coll("barrier").selected("barrier") == alg,
              f"barrier {alg} n={n} did not run")
        cases += 1
    var.var_set("coll_torch_barrier_algorithm", "auto")
    return (f"n={n}: {cases} (collective, algorithm, op) cases held "
            f"against the direct lowering, {bitwise} of them bit for bit "
            f"against the CPU port; largest float SUM/PROD error "
            f"{worst:.3g}; demoted by the reference's rules: "
            f"{', '.join(demoted) or 'none'}")


def _dispatch_us(fn, iters: int = 5) -> float:
    """Median host time of one ``fn()`` dispatch in µs, each started on
    an idle device queue (a schedule is a Python loop of launches)."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def _alg_times(w, smi: str) -> list:
    """Every (collective, algorithm) at 32 MB per rank on the 8-rank
    world, each checked against the direct lowering on the card (SUM
    rtol 1e-5, atol 1e-5; the rest exact) and timed: device ms (CUDA
    events, median of 5 after 2 warm-ups), the share of HBM for the
    least in+out traffic (phase 4's formula), and host µs of one
    dispatch."""
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((n, LOCAL_ELEMS), device="cuda", generator=g)
    y = torch.randn((n, n, LOCAL_ELEMS // n), device="cuda", generator=g)
    local = LOCAL_ELEMS * 4
    specs = [("allreduce", x, MPI.SUM, None), ("reduce", x, MPI.SUM, 2),
             ("bcast", x, None, 3), ("allgather", x, None, None),
             ("gather", x, None, 1), ("scatter", y, None, 5),
             ("alltoall", y, None, None),
             ("reduce_scatter_block", y, MPI.SUM, None),
             ("scan", x, MPI.SUM, None), ("exscan", x, MPI.SUM, None)]
    table = []
    for func, buf, op, root in specs:
        f = "scan" if func == "exscan" else func
        args = (buf,) + ((op,) if op is not None else ()) + \
            ((root,) if root is not None else ())

        def call():
            return getattr(w, func)(*args)
        var.var_set(_alg_var(func), ALG_BASELINE.get(f, "direct"))
        want = call()
        rows = root if func in ("reduce", "gather") else slice(None)
        read = local if func in ("bcast", "scatter") else buf.numel() * 4
        moved = read + want.numel() * want.element_size()
        for alg in ALGORITHMS[f][1:]:
            var.var_set(_alg_var(func), alg)
            got = call()
            ran = w._coll(func).selected(func, buf, op, root)
            what = f"{func} {alg} at 32 MB/rank"
            check(ran == _alg_expected(func, alg, n, op),
                  f"{what}: ran {ran}")
            if op is None:
                check(torch.equal(got[rows], want[rows]),
                      f"{what}: differs from the direct lowering")
            else:
                err = (got[rows].double() - want[rows].double()).abs() \
                    .max().item()
                check(bool(torch.allclose(got[rows], want[rows], rtol=1e-5,
                                          atol=1e-5)),
                      f"{what}: max abs err {err:.3g} against direct")
            del got
            ms = device_ms(call, iters=5, warmup=2)
            us = _dispatch_us(call)
            share = moved / ms / 1e9 / (HBM_BYTES_PER_S / 1e12)
            phase("algorithms", f"{func} {alg} (ran {ran}): {ms:.4f} ms "
                  f"device, {share:.1%} of {HBM_BYTES_PER_S / 1e12:.2f} "
                  f"TB/s for {moved / 1e6:.0f} MB in+out, host "
                  f"{us:.1f} us per dispatch | {smi}")
            table.append({"func": func, "algorithm": alg, "ran": ran,
                          "ms": ms, "hbm_share": share, "host_us": us})
        var.var_set(_alg_var(func), "auto")
        del want
        torch.cuda.empty_cache()
    mod = w._coll("barrier")
    for alg in ALGORITHMS["barrier"][1:]:
        var.var_set("coll_torch_barrier_algorithm", alg)
        ms = device_ms(mod._barrier_arrays, iters=5, warmup=2)
        us = _dispatch_us(mod._barrier_arrays)
        phase("algorithms", f"barrier {alg} (ran {mod.selected('barrier')})"
              f": {ms:.4f} ms device for the token schedule, host {us:.1f} "
              f"us per dispatch | {smi}")
    var.var_set("coll_torch_barrier_algorithm", "auto")
    return table


def phase_algorithms(w, smi: str) -> None:
    """Every schedule of coll/torch forced through its var: checks at 37
    elements per rank on the 8-rank world and on split sub-communicators
    of sizes 3, 5 and 6, then times at 32 MB per rank on the 8-rank
    world."""
    t0 = time.perf_counter()
    ops = {"SUM": MPI.SUM, "PROD": MPI.PROD, "MAX": MPI.MAX,
           "right_take": MPI.op_create(lambda a, b: b, commute=False)}
    n = w.size
    cpu_world = MPI.Communicator(MPI.Group(range(n)),
                                 [torch.device("cpu")] * n, name="cpu_world")
    for size in ALG_CHECK_SIZES:
        colors = [0] * size + [MPI.UNDEFINED] * (n - size)
        card = w if size == n else w.split(colors)[0]
        cpu = cpu_world if size == n else cpu_world.split(colors)[0]
        phase("algorithms", _alg_checks(card, cpu, ops))
    table = _alg_times(w, smi)
    for func in ALG_FUNCS:
        rows = [t for t in table if t["func"] == func]
        base = rows[0]["ms"]
        best = min(rows, key=lambda t: t["ms"])
        phase("algorithms", f"{func}: fastest {best['algorithm']} "
              f"{best['ms']:.4f} ms against {rows[0]['algorithm']} "
              f"{base:.4f} ms")
    phase("algorithms", f"phase 8 took {time.perf_counter() - t0:.1f} s")


# -- phase 9 -----------------------------------------------------------
CODECS = ("int8_block", "fp8_block", "null")
REAL_CODECS = ("int8_block", "fp8_block")
CODEC_BLOCK = 256
COMPRESS_ELEMS = (1 << 20, LOCAL_ELEMS)    # per rank: 4 MB and 32 MB fp32
# per-hop relative code step of each codec (codecs.error_bound / maxabs)
CODEC_EPS = {"int8_block": 1 / 254, "fp8_block": 1 / 16, "null": 0.0}
# The reference's envelopes (0.02 max|ref| for the reductions, max|x|/64
# for allgather) are int8_block's; fp8_block's error bound is 254/16 times
# int8's, so its envelopes are scaled by that ratio.
ENVELOPE_SCALE = {"int8_block": 1.0, "fp8_block": 254 / 16, "null": 1.0}
V_COUNTS = {37: [37 - 3 * r for r in range(N_RANKS)],
            LOCAL_ELEMS: [LOCAL_ELEMS - 4099 * r for r in range(N_RANKS)]}


def _wire() -> tuple:
    return (pvar.pvar_read("compress_bytes_in"),
            pvar.pvar_read("compress_bytes_out"))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality of two float tensors, NaN-aware (every NaN
    equals every NaN; all other values compare by their bits)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    a, b = a.contiguous(), b.contiguous()
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ity = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(ity)[~nan], b.view(ity)[~nan])


def _codec_checks(smi: str) -> None:
    """Each real codec's device half at 32 MB (one rank's row) on the card
    against the same call on the CPU: codes on finite blocks, scales and
    dequantized values NaN-aware, bit for bit. Blocks of scales spread
    over six decades; three blocks hold inf, nan and -inf."""
    E, blk = LOCAL_ELEMS, CODEC_BLOCK
    g = torch.Generator(device="cuda").manual_seed(21)
    spread = torch.logspace(-3, 3, E // blk, device="cuda")
    x = torch.randn(E, device="cuda", generator=g) * \
        spread.repeat_interleave(blk)
    x[1000], x[5000], x[9000] = math.inf, math.nan, -math.inf
    xc = x.cpu()
    for name in REAL_CODECS:
        c = get_codec(name)
        qc, qs = c.torch_quant(x, blk)
        dq = c.torch_dequant(qc, qs, E, torch.float32, blk)
        hc, hs = c.torch_quant(xc, blk)
        hd = c.torch_dequant(hc, hs, E, torch.float32, blk)
        fin = torch.isfinite(hs)
        check(int((~fin).sum()) == 3, f"{name}: {int((~fin).sum())} "
              "poisoned blocks, 3 expected")
        check(torch.equal(qc.cpu().view(-1, blk)[fin], hc.view(-1, blk)[fin]),
              f"{name}: card codes differ from the CPU's on finite blocks")
        check(_same_bits(qs.cpu(), hs), f"{name}: card scales differ")
        check(_same_bits(dq.cpu(), hd), f"{name}: card dequant differs")
        blocks = hd.view(-1, blk)
        check(bool(torch.isnan(blocks[~fin]).all()),
              f"{name}: a poisoned block kept a finite value")
        xb = xc.double().view(-1, blk)
        maxabs = xb.abs().amax(1).numpy()
        bound = torch.from_numpy(c.error_bound(maxabs))
        err = (xb - blocks.double()).abs().amax(1)
        # relative slack 1e-4: the float32 rounding of x / scale, of the
        # scale and of the dequantized product can move a rounding tie by
        # a few parts in 1e6 of the block's max
        over = err[fin] > bound[fin] * (1 + 1e-4)
        check(not bool(over.any()), f"{name}: error above error_bound in "
              f"{int(over.sum())} blocks")
        share = float((err[fin] / bound[fin]).max())
        q_ms = device_ms(lambda: c.torch_quant(x, blk), iters=10, warmup=2)
        d_ms = device_ms(lambda: c.torch_dequant(qc, qs, E, torch.float32,
                                                 blk), iters=10, warmup=2)
        nb = E // blk
        q_bound = (4 * E + E + 4 * nb) / HBM_BYTES_PER_S * 1e3
        d_bound = (E + 4 * nb + 4 * E) / HBM_BYTES_PER_S * 1e3
        phase("compression", f"{name} at 32 MB: card = CPU bit for bit "
              f"(codes on {int(fin.sum())} finite blocks, scales and "
              f"dequant NaN-aware; 3 poisoned blocks all NaN); largest "
              f"error {share:.6f} of error_bound; torch_quant {q_ms:.4f} "
              f"ms (bound {q_bound:.4f}, bytes), torch_dequant {d_ms:.4f} "
              f"ms (bound {d_bound:.4f}) | {smi}")


def _alg_ms(w, func, args, alg) -> float:
    var.var_set(_alg_var(func), alg)
    try:
        return device_ms(lambda: getattr(w, func)(*args), iters=5, warmup=2)
    finally:
        var.var_set(_alg_var(func), "auto")


def _compressed_colls(w, cw, ccpu, smi: str) -> list:
    """allreduce SUM, allgather and reduce_scatter_block on the
    compression comm at 4 MB and 32 MB per rank for every codec: against
    float64 numpy (0.02 max|ref| for the reductions, max|x|/64 for
    allgather, the reference's envelopes, times ENVELOPE_SCALE), rows
    identical across ranks,
    bit for bit against the CPU port, wire ratio from the pvars (<= 0.3
    for the real codecs); device ms against the plain schedules and host
    us per dispatch."""
    n, rows = w.size, []
    for elems in COMPRESS_ELEMS:
        g = torch.Generator(device="cuda").manual_seed(31 + elems)
        x = torch.randn((n, elems), device="cuda", generator=g)
        y = torch.randn((n, n, elems // n), device="cuda", generator=g)
        xh, yh = x.cpu(), y.cpu()
        refs = {"allreduce": xh.double().sum(0),
                "reduce_scatter_block": yh.double().sum(0)}
        plain = {"allreduce": [("direct", _alg_ms(w, "allreduce",
                                                  (x, MPI.SUM), "direct")),
                               ("ring_segmented", _alg_ms(
                                   w, "allreduce", (x, MPI.SUM),
                                   "ring_segmented"))],
                 "allgather": [("direct", _alg_ms(w, "allgather", (x,),
                                                  "direct"))],
                 "reduce_scatter_block": [("direct", _alg_ms(
                     w, "reduce_scatter_block", (y, MPI.SUM), "direct"))]}
        for name in CODECS:
            var.var_set("mpi_base_compress_codec", name)
            for func, buf, host, op in (
                    ("allreduce", x, xh, MPI.SUM),
                    ("allgather", x, xh, None),
                    ("reduce_scatter_block", y, yh, MPI.SUM)):
                args = (buf,) + ((op,) if op else ())
                what = f"compressed {func} {name} at {elems * 4 >> 20} MB"
                check(cw._coll(func).selected(func, buf, op) ==
                      f"compressed:{name}", f"{what}: not selected")
                w0 = _wire()
                got = getattr(cw, func)(*args)
                torch.cuda.synchronize()
                w1 = _wire()
                moved_in, moved_out = w1[0] - w0[0], w1[1] - w0[1]
                check(moved_in > 0, f"{what}: no compressed bytes counted")
                ratio = moved_out / moved_in
                if name != "null":
                    check(ratio <= 0.3, f"{what}: wire ratio {ratio:.3f}")
                cpu = getattr(ccpu, func)(host, *args[1:])
                got_h = got.cpu()
                check(_same_bits(got_h, cpu), f"{what}: card differs from "
                      f"the CPU port")
                if func == "allgather":
                    env = float(xh.abs().max()) / 64 * ENVELOPE_SCALE[name]
                    err = max(float((got_h[r].double() - xh.double())
                                    .abs().max()) for r in range(n))
                    scale = float(xh.abs().max())
                    same = all(torch.equal(got_h[r], got_h[0])
                               for r in range(1, n))
                else:
                    ref = refs[func]
                    scale = float(ref.abs().max())
                    env = 0.02 * scale * ENVELOPE_SCALE[name]
                    err = float((got_h.double() - ref).abs().max())
                    same = (func != "allreduce" or
                            bool((got_h == got_h[:1]).all()))
                check(err <= env, f"{what}: max abs err {err:.4g} > "
                      f"envelope {env:.4g}")
                check(same, f"{what}: rows differ across ranks")
                del got, got_h, cpu
                ms = device_ms(lambda: getattr(cw, func)(*args), iters=5,
                               warmup=2)
                us = _dispatch_us(lambda: getattr(cw, func)(*args))
                vs = ", ".join(f"{a} {m:.4f} ms (x{ms / m:.2f})"
                               for a, m in plain[func])
                phase("compression", f"{what}: wire ratio {ratio:.4f} "
                      f"({moved_out} of {moved_in} B); max rel err "
                      f"{err / scale:.3g} (envelope {env / scale:.3g}); card "
                      f"= CPU bit for bit; {ms:.4f} ms device against "
                      f"uncompressed {vs}; host {us:.1f} us per dispatch "
                      f"| {smi}")
                rows.append({"func": func, "codec": name, "ms": ms,
                             "ratio": ratio, "rel_err": err / scale})
                torch.cuda.empty_cache()
        del x, y
    var.var_set("mpi_base_compress_codec", "int8_block")
    return rows


def _gates(w, cw) -> str:
    """With the var off, a MAX op, int32 data, or a payload under the
    floor: bit-identical to the plain path, and no compressed byte."""
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(41)
    x = torch.randn((n, 1 << 20), device="cuda", generator=g)
    y = torch.randn((n, n, (1 << 20) // n), device="cuda", generator=g)
    xi = torch.randint(-1000, 1000, (n, 1 << 20), device="cuda",
                       dtype=torch.int32, generator=g)
    small = x[:, :1000].contiguous()
    cases = [("MAX", "allreduce", (x, MPI.MAX)),
             ("int32 SUM", "allreduce", (xi, MPI.SUM)),
             ("under the floor", "allreduce", (small, MPI.SUM)),
             ("under the floor", "allgather", (small,))]
    off = [("var off", "allreduce", (x, MPI.SUM)),
           ("var off", "allgather", (x,)),
           ("var off", "reduce_scatter_block", (y, MPI.SUM))]
    for i, (why, func, args) in enumerate(cases + off):
        if i == len(cases):
            var.var_set("mpi_base_compress", False)
        w0 = _wire()
        got = getattr(cw, func)(*args)
        torch.cuda.synchronize()
        check(_wire() == w0, f"{func} ({why}): compressed bytes moved")
        check(torch.equal(got, getattr(w, func)(*args)),
              f"{func} ({why}): differs from the plain path")
    var.var_set("mpi_base_compress", True)
    held = ", ".join(f"{f} ({why})" for why, f, _ in cases + off)
    return (f"gates held: {held} bit-identical to the plain path with no "
            f"compressed byte")


def _plans(w, cw) -> str:
    """allreduce_bind and a persistent plan on the compression comm at 4 MB
    per rank; Startall over 16 members of 32 KiB per rank with the floor
    at 256 KiB and 1 MiB buckets: the fused bucket takes the codec."""
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(51)
    x = torch.randn((n, 1 << 20), device="cuda", generator=g)
    want = cw.allreduce(x, MPI.SUM)
    w0 = _wire()
    got = cw.allreduce_bind(x, MPI.SUM)(x)
    torch.cuda.synchronize()
    check(_wire()[0] > w0[0], "allreduce_bind: the codec did not engage")
    check(torch.equal(got, want), "allreduce_bind differs from allreduce")
    req = cw.allreduce_init(x, MPI.SUM)
    check(req.plan.codec == "int8_block", f"plan codec {req.plan.codec}")
    req.start()
    check(torch.equal(req.get(), want), "persistent plan differs")
    small = w.allreduce_init(x[:, :8], MPI.SUM)
    check(small.plan.codec is None, "a plain comm's plan has a codec")
    var.var_set("mpi_base_compress_min_bytes", 256 << 10)
    var.var_set("mpi_base_bucket", True)
    var.var_set("mpi_base_bucket_bytes", 1 << 20)
    try:
        c2 = w.dup()
        xs = [torch.randn((n, 8192), device="cuda", generator=g)
              for _ in range(16)]
        reqs = [c2.allreduce_init(b, MPI.SUM) for b in xs]
        check(all(r.plan.codec is None for r in reqs),
              "a 32 KiB member plan took the codec")
        f0 = persistent.counters()["coll_bucket_flushes"]
        w0 = _wire()
        MPI.Startall(reqs)
        outs = [r.get() for r in reqs]
        w1 = _wire()
        flushes = persistent.counters()["coll_bucket_flushes"] - f0
        check(w1[0] > w0[0], "the fused bucket did not take the codec")
        ratio = (w1[1] - w0[1]) / (w1[0] - w0[0])
        check(ratio <= 0.3, f"fused bucket wire ratio {ratio:.3f}")
        worst = 0.0
        for b, o in zip(xs, outs):
            ref = b.double().sum(0)
            err = float((o[0].double() - ref).abs().max())
            check(err <= 0.02 * float(ref.abs().max()),
                  f"bucket member error {err:.3g}")
            check(bool((o == o[:1]).all()), "bucket member rows differ")
            worst = max(worst, err / float(ref.abs().max()))
        for r in reqs + [req, small]:
            r.free()
    finally:
        var.var_set("mpi_base_bucket", False)
        var.var_set("mpi_base_bucket_bytes", 1 << 20)
        var.var_set("mpi_base_compress_min_bytes", 4 << 20)
    return (f"allreduce_bind and allreduce_init (plan.codec int8_block) at "
            f"4 MB equal the compressed allreduce bit for bit; Startall "
            f"over 16 x 32 KiB plans (no member codec): {flushes} fused "
            f"flush(es) took the codec, wire ratio {ratio:.4f}, largest "
            f"member rel err {worst:.3g} (envelope 0.02)")


class _TappedSync(T.BucketedGradSync):
    """BucketedGradSync that keeps each step's gradients and the synced
    means, so the codec's error is held against its bound."""

    taps: list

    def __call__(self, grads):
        out = super().__call__(grads)
        self.taps.append((tree_leaves(grads), tree_leaves(out)))
        return out


def _sync_bound(grads, eps: float, n: int) -> float:
    """Bound on |synced mean - exact mean| for one step: every element of
    a partial sum is at most S = sum_r max|g_r| in size, a ring allreduce
    quantizes each element n times (n-1 reduce-scatter hops, then the
    allgather codes), each within eps of its block's max, and the block
    max of the finished sum grows by at most n*eps*S; the mean divides by
    n."""
    s = sum(max(float(leaf[r].abs().max()) for leaf in grads)
            for r in range(n))
    return s * eps * (1 + n * eps)


def _ddp_compressed(w, smi: str) -> None:
    """The phase 7 DDP step on dp=8 through BucketedGradSync, bucket on:
    (a) uncompressed, (d) on a comm with compression on and the floor at
    64 KiB, so the fused buckets take the codec."""
    dev = torch.device("cuda", 0)
    n = w.size
    cfg = dataclasses.replace(CONFIG, dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    mesh = Mesh((n,), ("dp",), dev)
    specs = tree_map(lambda _: P(), params)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2 * n, cfg.seq + 1)))
    batch = mesh.shard((tok[:, :-1], tok[:, 1:]), (P("dp"), P("dp")))
    dpc = InGraphComm("dp", n, mesh)
    start = mesh.shard(params, specs)
    lr = 1e-2
    var.var_set("mpi_base_bucket", True)
    var.var_set("mpi_base_compress_min_bytes", 64 << 10)
    cd = w.dup()
    mod = cd._coll("allreduce")
    engaged: list = []
    flat_allreduce = mod.allreduce

    def recording(x, op):
        engaged.append((x.nbytes // n >> 10, mod._eligible("allreduce", x,
                                                            op)))
        return flat_allreduce(x, op)
    mod.allreduce = recording
    syncs = {"a": _TappedSync(w, start), "d": _TappedSync(cd, start)}
    runs = {}
    for kind, sync in syncs.items():
        sync.taps = []
        p, losses, ps = start, [], []
        for _ in range(2):
            p, loss = T.sgd_train_step(p, batch, cfg, lr, dpc,
                                       grad_sync=sync)
            losses.append(float(loss[0]))
            ps.append(p)
            check(mesh.divergence(p, specs) <= 1e-6,
                  f"DDP ({kind}): replicated leaves diverged")
        runs[kind] = {"losses": losses, "params": ps, "ms": []}
    steps = engaged[:]
    eps = CODEC_EPS["int8_block"]
    bounds = []
    for grads, out in syncs["d"].taps:
        b = _sync_bound(grads, eps, n)
        err = max(float((o[0].double() - g.double().mean(0)).abs().max())
                  for g, o in zip(grads, out))
        check(err <= b, f"DDP (d): synced grads off by {err:.3g}, bound "
              f"{b:.3g}")
        bounds.append((err, b))
    la, ld = runs["a"]["losses"], runs["d"]["losses"]
    pa, pd = runs["a"]["params"], runs["d"]["params"]

    def pdiff(i):
        return max(float((a - d).abs().max())
                   for a, d in zip(tree_leaves(pa[i]), tree_leaves(pd[i])))
    pmax = max(float(t.abs().max()) for t in tree_leaves(start))
    d1, d2 = pdiff(0), pdiff(1)
    tol1 = lr * bounds[0][1] + 2 * 2 ** -23 * pmax
    tol2 = 2 * (tol1 + lr * bounds[1][1])
    g2 = syncs["a"].taps[1][1]
    g2_l1 = sum(float(o[0].double().abs().sum()) for o in g2)
    ltol = 2 * g2_l1 * d1 + 1e-6 * abs(la[1])
    check(abs(ld[0] - la[0]) <= 1e-6 * abs(la[0]),
          f"DDP (d) step-1 loss {ld[0]} != (a) {la[0]}")
    check(d1 <= tol1, f"DDP (d) step-1 params off by {d1:.3g} > {tol1:.3g}")
    check(d2 <= tol2, f"DDP (d) step-2 params off by {d2:.3g} > {tol2:.3g}")
    check(abs(ld[1] - la[1]) <= ltol, f"DDP (d) step-2 loss {ld[1]} vs "
          f"{la[1]}, tolerance {ltol:.3g}")
    for kind in ("a", "d", "d", "a"):               # times in turns
        step = (lambda s=syncs[kind]: T.sgd_train_step(
            start, batch, cfg, lr, dpc, grad_sync=s))
        runs[kind]["ms"].append(host_ms(step, iters=10, warmup=2))
    mod.allreduce = flat_allreduce
    var.var_set("mpi_base_bucket", False)
    var.var_set("mpi_base_compress_min_bytes", 4 << 20)
    per_step = len(steps) // 2
    phase("compression", f"DDP dp=8 bucket on, compression floor 64 KiB: "
          f"fused buckets per step (KiB per rank, took the codec) "
          f"{steps[:per_step]}; synced-grad error {bounds[0][0]:.3g}, "
          f"{bounds[1][0]:.3g} against bounds {bounds[0][1]:.3g}, "
          f"{bounds[1][1]:.3g} (S*eps*(1+n*eps), eps 1/254)")
    phase("compression", f"DDP (d) against (a): losses {ld[0]!r} and "
          f"{la[0]!r} (same params: rtol 1e-6), {ld[1]!r} and {la[1]!r} "
          f"(tolerance {ltol:.3g}: "
          f"twice the first-order change, |g2|_1 * max|dp1|); params max "
          f"abs diff {d1:.3g} (bound lr*err1 + 2 ulp = {tol1:.3g}), "
          f"{d2:.3g} (limit {tol2:.3g}, twice the summed bounds)")
    phase("compression", "DDP step ms (timed in turns a d d a; host clock, "
          "synchronised, median of 10 after 2 warm-ups): " + "; ".join(
              f"({k}) {' and '.join(f'{m:.3f}' for m in r['ms'])}"
              for k, r in runs.items()) + f" | {smi}")


def _vforms(w, cw) -> str:
    """Each v- and root-form with ragged counts against numpy, exactly
    (reduce_scatter: float SUM rtol 1e-5 / atol 1e-5, phase 4's), at 37
    elements and 32 MB per rank; the i-forms against the blocking calls;
    reduce_scatter on the compression comm takes the codec."""
    n, out = w.size, []
    for elems, counts in V_COUNTS.items():
        g = torch.Generator(device="cuda").manual_seed(61 + elems)
        per = [torch.randn(c, device="cuda", generator=g) for c in counts]
        host = [p.cpu().numpy() for p in per]
        cat = np.concatenate(host)
        for r, o in enumerate(w.allgatherv(per)):
            check(o.is_cuda and np.array_equal(o.cpu().numpy(), cat),
                  f"allgatherv row {r} at {elems}")
        check(np.array_equal(w.gatherv(per, 3).cpu().numpy(), cat),
              f"gatherv at {elems}")
        for r, o in enumerate(w.scatterv(per, 5)):
            check(np.array_equal(o.cpu().numpy(), host[r]),
                  f"scatterv row {r} at {elems}")
        ach = [[per[(i + j) % n][:counts[(i * j) % n] // n + j]
                for j in range(n)] for i in range(n)]
        recv = w.alltoallv(ach)
        check(all(torch.equal(recv[j][i], ach[i][j]) for i in range(n)
                  for j in range(n)), f"alltoallv at {elems}")
        total = sum(counts)
        x = torch.randn((n, total), device="cuda", generator=g)
        red = x.cpu().double().sum(0).numpy()
        offs = np.concatenate([[0], np.cumsum(counts)])
        for r, o in enumerate(w.reduce_scatter(x, counts)):
            _close(o.cpu().numpy(), red[offs[r]:offs[r + 1]], 1e-5, 1e-5,
                   f"reduce_scatter row {r} at {elems}")
        st = w.stack(per_rank=[p[:counts[-1]] for p in per])
        check(torch.equal(w.gather_root(st, 2), st), "gather_root")
        check(torch.equal(w.scatter_root(st, 4), st), "scatter_root")
        for name, nb, blocking in (
                ("iallgatherv", lambda: w.iallgatherv(per),
                 lambda: w.allgatherv(per)),
                ("igatherv", lambda: w.igatherv(per, 1),
                 lambda: w.gatherv(per, 1)),
                ("iscatterv", lambda: w.iscatterv(per, 6),
                 lambda: w.scatterv(per, 6)),
                ("ialltoallv", lambda: w.ialltoallv(ach),
                 lambda: [c for row in w.alltoallv(ach) for c in row])):
            got = nb().get()
            got = [c for row in got for c in row] if name == "ialltoallv" \
                else got
            want = blocking()
            check(all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, list) else [got],
                want if isinstance(want, list) else [want])), name)
        out.append(f"{elems} elements per rank (counts {counts[0]}.."
                   f"{counts[-1]})")
        if elems == LOCAL_ELEMS:
            w0 = _wire()
            cs = cw.reduce_scatter(x, counts)
            torch.cuda.synchronize()
            check(_wire()[0] > w0[0], "reduce_scatter on the compression "
                  "comm did not take the codec")
            err = max(float(np.abs(o.cpu().double().numpy()
                                   - red[offs[r]:offs[r + 1]]).max())
                      for r, o in enumerate(cs))
            check(err <= 0.02 * float(np.abs(red).max()),
                  f"compressed reduce_scatter err {err:.3g}")
        del per, x
        torch.cuda.empty_cache()
    return (f"allgatherv, gatherv, scatterv, alltoallv, gather_root, "
            f"scatter_root exact and reduce_scatter within rtol 1e-5 / atol "
            f"1e-5 against numpy at {' and '.join(out)}; the i-forms equal "
            f"the blocking calls; reduce_scatter at 32 MB on the compression "
            f"comm took the codec (rel err {err / np.abs(red).max():.3g})")


def phase_compression(w, smi: str) -> None:
    """Codecs, compressed collectives, gates, plans and DDP, and the v-
    and root-forms on the 8-rank cuda:0 world."""
    t0 = time.perf_counter()
    _codec_checks(smi)
    n = w.size
    cpu_world = MPI.Communicator(MPI.Group(range(n)),
                                 [torch.device("cpu")] * n, name="cpu_world")
    var.var_set("mpi_base_compress", True)
    cw, ccpu = w.dup(), cpu_world.dup()
    check(cw._coll_winners["allreduce"] == "compressed" and
          w._coll_winners["allreduce"] == "tuned",
          f"winners {cw._coll_winners}")
    table = decision.decision_table(n, platform="gpu")
    check(all(any(row[2] == "compressed:int8_block" for row in table[f])
              for f in ("allreduce", "allgather", "reduce_scatter_block")),
          "decision_table lacks the compression rows")
    rows = _compressed_colls(w, cw, ccpu, smi)
    phase("compression", _gates(w, cw))
    phase("compression", _plans(w, cw))
    _ddp_compressed(w, smi)
    phase("compression", _vforms(w, cw))
    var.var_set("mpi_base_compress", False)
    worst = max(r["ratio"] for r in rows if r["codec"] != "null")
    phase("compression", f"largest real-codec wire ratio {worst:.4f} (limit "
          f"0.3); compress_ratio pvar over the phase "
          f"{pvar.pvar_read('compress_ratio'):.4f}; phase 9 took "
          f"{time.perf_counter() - t0:.1f} s")


# -- phase 10 ----------------------------------------------------------
MAT = (4096, 2048)             # 32 MB of fp32 per rank, a matrix
NBR_ELEMS = 2 << 20            # 8 MB of fp32 per rank for the topologies
DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
          torch.int32, torch.int64, torch.int16, torch.int8, torch.uint8,
          torch.uint16, torch.uint32, torch.uint64, torch.bool,
          torch.complex64, torch.complex128)


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _bits(a, b) -> bool:
    """Bit-for-bit equality of two arrays or tensors (shape, dtype and
    every byte, NaN and -0.0 included)."""
    a, b = np.ascontiguousarray(_host(a)), np.ascontiguousarray(_host(b))
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def _hbm(nbytes: int, ms: float) -> str:
    return (f"{nbytes / 1e6:.0f} MB, {nbytes / ms / 1e6:.1f} GB/s "
            f"({nbytes / ms / 1e9 / (HBM_BYTES_PER_S / 1e12):.1%} of "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)")


def _ring(w, buf, tag: int, sends_first: bool, clobber: bool = False):
    """Each rank r sends its row to r + 1 and receives from r - 1:
    receives posted first (matched at send) or sends first (queued as
    unexpected, matched at receive). ``clobber`` writes over the whole
    send buffer before the receives complete."""
    n = w.size
    post = lambda: [w.irecv((r - 1) % n, tag, dst=r) for r in range(n)]
    reqs = [] if sends_first else post()
    for r in range(n):
        w.send(buf[r], src=r, dest=(r + 1) % n, tag=tag)
    if clobber:
        buf.fill_(-1.0)
    if sends_first:
        reqs = post()
    return [q.get() for q in reqs], [q.status for q in reqs]


def _ptp(w, cpu, smi: str) -> None:
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(101)
    x = torch.randn((n, LOCAL_ELEMS), device="cuda", generator=g)
    xh = x.cpu().numpy()
    want = [xh[(r - 1) % n] for r in range(n)]
    cpu_got, _ = _ring(cpu, torch.from_numpy(xh.copy()), 1, True)
    for sends_first in (False, True):
        got, sts = _ring(w, x, 1, sends_first)
        check(all(o.device == x.device for o in got), "ring off the card")
        check(all(_bits(o, want[r]) and _bits(o, cpu_got[r])
                  for r, o in enumerate(got)),
              f"ring (sends first: {sends_first}) against numpy / CPU port")
        check([(s.source, s.tag, s.count) for s in sts]
              == [((r - 1) % n, 1, LOCAL_ELEMS) for r in range(n)],
              "ring statuses")
    got, _ = _ring(w, x.clone(), 2, True, clobber=True)
    check(all(_bits(o, want[r]) for r, o in enumerate(got)),
          "a message changed when its sender wrote over the buffer")
    del got, cpu_got
    moved = 2 * LOCAL_ELEMS * 4 * n
    ms = {sf: device_ms(lambda sf=sf: _ring(w, x, 3, sf), iters=10,
                        warmup=2) for sf in (False, True)}
    phase("ptp", f"sendrecv ring, 8 x 32 MB fp32 (eager limit "
          f"{var.var_get('pml_stacked_eager_limit')} B): = numpy = CPU port "
          f"bit for bit, receives posted first and sends first; each "
          f"message unchanged after its sender wrote -1 over the buffer; "
          f"device {ms[False]:.4f} ms posted first, {ms[True]:.4f} ms "
          f"sends first; {_hbm(moved, ms[False])} | {smi}")

    req = w.irecv(0, 5, dst=1)
    w.ssend(x[0], src=0, dest=1, tag=5)
    check(req.test()[0] and _bits(req.get(), xh[0]), "ssend to posted irecv")
    try:
        w.ssend(x[0], src=0, dest=1, tag=6)
        check(False, "unmatched ssend did not raise")
    except MPI.MPIError as e:
        check(e.error_class == MPI.ERR_PENDING, f"ssend raised {e}")
    parts = list(x[2].view(16, -1))
    sreq = w.psend_init(parts, dest=3, tag=9, src=2)
    rreq = w.precv_init(2, 9, 16, dst=3)

    def partitioned():
        sreq.start()
        rreq.start()
        for i in range(16):
            sreq.pready(i)
        rreq.wait()
        return rreq.get()
    got = partitioned()
    check(sreq.test()[0] and all(rreq.parrived(i) for i in range(16)),
          "partitions")
    check(_bits(torch.cat(got), xh[2]), "partitioned 16 x 2 MB")
    p_ms = device_ms(partitioned, iters=10, warmup=2)

    small = torch.ones(2, device="cuda")                 # 8 B
    pair = []
    for _ in range(1000):
        t0 = time.perf_counter()
        w.send(small, src=0, dest=1, tag=4)
        w.recv(0, 4, dst=1)
        pair.append((time.perf_counter() - t0) * 1e6)
    for i in range(256):
        w.send(small, src=i % n, dest=0, tag=i)
    match = []
    for i in range(1000):
        t0 = time.perf_counter()
        _, st = w.recv(MPI.ANY_SOURCE, MPI.ANY_TAG, dst=0)
        match.append((time.perf_counter() - t0) * 1e6)
        w.send(small, src=st.source, dest=0, tag=st.tag)
    for _ in range(256):
        w.recv(MPI.ANY_SOURCE, MPI.ANY_TAG, dst=0)
    check(w.iprobe(MPI.ANY_SOURCE, MPI.ANY_TAG, dst=0) == (False, None),
          "wildcard queue drained")
    torch.cuda.synchronize()
    phase("ptp", f"ssend to a posted irecv matched, unmatched ssend raised "
          f"ERR_PENDING; partitioned 16 x 2 MB = numpy, device "
          f"{p_ms:.4f} ms ({_hbm(2 * LOCAL_ELEMS * 4, p_ms)}); 8 B send + "
          f"recv pair {statistics.median(pair):.2f} us (host clock, median "
          f"of 1000); ANY_SOURCE/ANY_TAG recv with 256 queued "
          f"{statistics.median(match):.2f} us (median of 1000) | {smi}")


def _probe_dtypes() -> str:
    """The convertor's gather, scatter and keep-last scatter on the card
    for every predefined base type, against a host loop."""
    ok, bad = [], []
    for dt in DTYPES:
        vec = MPI.Datatype(dt).create_vector(3, 1, 2).commit()  # 0, 2, 4
        ovl = vec.create_resized(0, 2).commit()       # instances overlap
        src = torch.arange(20, device="cuda").view(2, 10).to(dt)
        try:
            p = convertor.pack(src, vec, 2)
            u = convertor.unpack(torch.zeros_like(src), p, vec, 2)
            o = convertor.unpack(torch.zeros((2, 7), dtype=dt,
                                             device="cuda"), p, ovl, 2)
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError) as e:
            bad.append(f"{dt} ({type(e).__name__}: {str(e)[:80]})")
            continue
        sh, ph = src.cpu(), p.cpu()
        want_u, want_o = torch.zeros_like(sh), torch.zeros((2, 7), dtype=dt)
        for c, pos in enumerate(vec.flat_indices(2).tolist()):
            check(bool((ph[:, c] == sh[:, pos]).all()), f"pack {dt}")
            want_u[:, pos] = sh[:, pos]
        for c, pos in enumerate(ovl.flat_indices(2).tolist()):
            want_o[:, pos] = ph[:, c]                # the last writer wins
        check(torch.equal(u.cpu(), want_u) and torch.equal(o.cpu(), want_o),
              f"convertor on the card for {dt}")
        ok.append(str(dt).replace("torch.", ""))
    return (f"convertor pack/unpack/keep-last unpack on the card = host "
            f"loop for {', '.join(ok)}; cannot run: {', '.join(bad) or 'none'}")


def _datatypes(w, cpu, smi: str) -> None:
    n, L = w.size, MAT[0] * MAT[1]
    g = torch.Generator(device="cuda").manual_seed(103)
    x = torch.randn((n, L), device="cuda", generator=g)
    xh = x.cpu().numpy()
    types = {
        "vector(4096, 1024, 2048) resized to the matrix":
            MPI.FLOAT.create_vector(MAT[0], 1024, MAT[1])
            .create_resized(0, L).commit(),
        "subarray (2048, 1024) at (1024, 512)":
            MPI.FLOAT.create_subarray(MAT, (2048, 1024), (1024, 512))
            .commit(),
    }
    mod = w._coll("allreduce")
    for name, t in types.items():
        idx = t.flat_indices(1)
        k = idx.size
        holes = np.ones(L, bool)
        holes[idx] = False
        p = convertor.pack(x, t, 1)
        check(_bits(p, xh[:, idx]), f"{name}: pack")
        u = convertor.unpack(torch.zeros_like(x), p, t, 1)
        uh = u.cpu().numpy()
        check(_bits(uh[:, idx], xh[:, idx]) and not uh[:, holes].any(),
              f"{name}: unpack")
        del u, uh
        moved = 2 * n * k * 4 + k * 8
        pk = device_ms(lambda: convertor.pack(x, t, 1), iters=10, warmup=2)
        out = torch.zeros_like(x)
        up = device_ms(lambda: convertor.unpack(out, p, t, 1), iters=10,
                       warmup=2)
        del out
        xf = x.clone()
        y = w.allreduce(MPI.IN_PLACE, MPI.SUM, datatype=t, recvbuf=xf)
        check(y is xf and any(key[0] == "allreduce_dt" and key[4] == t.uid
                              for key in mod._fast), f"{name}: not fused")
        yh = y.cpu().numpy()
        check(_bits(yh[:, holes], xh[:, holes]), f"{name}: holes changed")
        _close(yh[:, idx], np.broadcast_to(
            xh[:, idx].astype(np.float64).sum(0), (n, k)), 1e-5, 1e-5,
            f"{name}: fused SUM")
        xu = x.clone()
        packed, unpack_fn = w._wire(xu, t, 1)
        unpack_fn(w.allreduce(packed, MPI.SUM), xu)
        check(torch.equal(xu, y), f"{name}: fused != unfused chain")
        del yh, xu, packed
        ym = w.allreduce(MPI.IN_PLACE, MPI.MAX, datatype=t,
                         recvbuf=x.clone())
        ycm = cpu.allreduce(MPI.IN_PLACE, MPI.MAX, datatype=t,
                            recvbuf=torch.from_numpy(xh.copy()))
        check(_bits(ym, ycm), f"{name}: MAX card != CPU port")
        del ym, ycm
        xs = x.clone()
        fused = device_ms(lambda: w.allreduce(
            MPI.IN_PLACE, MPI.SUM, datatype=t, recvbuf=xs), iters=8,
            warmup=2)
        xs.copy_(x)

        def unfused():
            pk_, un = w._wire(xs, t, 1)
            un(w.allreduce(pk_, MPI.SUM), xs)
        chain = device_ms(unfused, iters=8, warmup=2)
        contig = device_ms(lambda: w.allreduce(p, MPI.SUM), iters=8,
                           warmup=2)
        del xs
        phase("datatype", f"{name}: {k} of {L} elements per rank; pack "
              f"{pk:.4f} ms ({_hbm(moved, pk)}), unpack {up:.4f} ms "
              f"({_hbm(moved, up)}); in-place allreduce SUM fused "
              f"{fused:.4f} ms, unfused _wire chain {chain:.4f} ms, "
              f"contiguous allreduce of the {n * k * 4 / 1e6:.0f} MB packed "
              f"{contig:.4f} ms; holes unchanged bit for bit, SUM within "
              f"rtol 1e-5 / atol 1e-5 of float64 numpy, fused = unfused, "
              f"MAX = CPU port bit for bit | {smi}")
    vec = next(iter(types.values()))
    idx = vec.flat_indices(1)
    b = w.bcast(x, root=2, datatype=vec)
    bh = b.cpu().numpy()
    check(_bits(bh[:, idx], np.broadcast_to(xh[2, idx], (n, idx.size)))
          and not bh[:, np.setdiff1d(np.arange(L), idx)].any(),
          "bcast with the vector type")
    del b, bh
    a, c = x[0], x[1]
    rl = MPI.reduce_local(a, c, MPI.SUM)
    check(_bits(rl, xh[0] + xh[1]), "reduce_local SUM at 32 MB")
    rl_ms = device_ms(lambda: MPI.reduce_local(a, c, MPI.SUM), iters=10,
                      warmup=2)
    kinds = [MPI.FLOAT.create_vector(3, 2, 5).commit(),
             MPI.FLOAT.create_indexed([1, 3], [0, 4]).commit(), None,
             MPI.FLOAT.create_subarray((4, 6), (2, 3), (1, 2)).commit()]
    tys = [[kinds[(i + j) % 4] for j in range(n)] for i in range(n)]
    chunks = [[torch.randn(((t.extent if t else 3) * (1 + (i * j) % 3),),
                           device="cuda", generator=g)
               for j, t in enumerate(row)] for i, row in enumerate(tys)]
    recv = w.alltoallw(chunks, tys)
    for i in range(n):
        for j in range(n):
            t, ch = tys[i][j], chunks[i][j].cpu().numpy()
            cnt = (1 + (ch.size - sum(t.get_true_extent())) // t.extent
                   if t else None)
            want = ch[t.flat_indices(cnt)] if t else ch
            check(recv[j][i].is_cuda and _bits(recv[j][i], want),
                  f"alltoallw {i} -> {j}")
    ov = MPI.FLOAT.create_vector(2, 2, 3).create_resized(0, 3).commit()
    cnt = 1 << 18
    oidx = ov.flat_indices(cnt)
    packed = torch.randn((n, oidx.size), device="cuda", generator=g)
    got = convertor.unpack(torch.zeros((n, 3 * cnt + 2), device="cuda"),
                           packed, ov, cnt)
    want = np.zeros((n, 3 * cnt + 2), np.float32)
    want[:, oidx] = packed.cpu().numpy()
    check(_bits(got, want), "overlapping resized type: unpack != numpy's "
          "last writer")
    phase("datatype", f"bcast with the vector type = numpy; reduce_local "
          f"SUM at 32 MB = numpy bit for bit, {rl_ms:.4f} ms "
          f"({_hbm(3 * LOCAL_ELEMS * 4, rl_ms)}); alltoallw over vector, "
          f"indexed, contiguous and subarray chunks of 3-72 elements = "
          f"numpy; an overlapping resized type ({oidx.size} indices onto "
          f"{len(set(oidx.tolist()))} positions) unpacks to numpy's "
          f"last-writer result | {smi}")
    phase("datatype", _probe_dtypes())


def _nbr_check(what, comm, cpu_comm, fn, x):
    """The device path's result against the host path (numpy) and the
    CPU port, bit for bit; every output on cuda:0. Returns the least
    traffic of the call: every input row that some rank receives read
    once (at most the input's bytes), every output written once."""
    dev = fn(comm, x)
    host = fn(comm, _nested(x, _host))
    cpu = fn(cpu_comm, _nested(x, lambda t: torch.from_numpy(_host(t))))
    d, h, c = _flat(dev), _flat(host), _flat(cpu)
    check(all(a.device == torch.device("cuda", 0) for a in d),
          f"{what}: an output is off cuda:0")
    check(len(d) == len(h) == len(c) and all(
        (a.numel() == 0 and np.asarray(b).size == 0) or _bits(a, b)
        for a, b in zip(d, h)) and all(_bits(a, b) for a, b in zip(d, c)),
        f"{what}: device != host path / CPU port")
    out = sum(a.numel() * a.element_size() for a in d)
    ins = sum(a.numel() * a.element_size() for a in _flat(x))
    return min(ins, out) + out


def _flat(v) -> list:
    if isinstance(v, (list, tuple)):
        return [a for b in v for a in _flat(b)]
    return [v]


def _nested(x, f):
    if isinstance(x, list):
        return [_nested(a, f) for a in x]
    return f(x)


def _topologies(w, cpu, smi: str) -> None:
    n = w.size
    g = torch.Generator(device="cuda").manual_seed(107)
    lines = []

    def timed(what, comm, cpu_comm, fn, x):
        nbytes = _nbr_check(what, comm, cpu_comm, fn, x)
        ms = device_ms(lambda: fn(comm, x), iters=10, warmup=2)
        lines.append(f"{what} {ms:.4f} ms ({_hbm(nbytes, ms)})")

    cart = w.create_cart([2, 4], [True, False])
    ccart = cpu.create_cart([2, 4], [True, False])
    check(cart.cart_shift(0, 0, 1) == (4, 4) and
          cart.cart_shift(0, 1, 1) == (-2, 1), "cart_shift")
    x = torch.randn((n, NBR_ELEMS), device="cuda", generator=g)
    timed("cart 2x4 neighbor_allgather (8 MB per rank)", cart, ccart,
          lambda c, b: c.neighbor_allgather(b), x)
    y = torch.randn((n, 4, NBR_ELEMS // 4), device="cuda", generator=g)
    timed("neighbor_alltoall (4 x 2 MB chunks)", cart, ccart,
          lambda c, b: c.neighbor_alltoall(b), y)
    src = [[1], [0, 0, 2], [1, 2], [-2, 4], [3, 5], [4], [7], [6, 3]]
    dst = [[1, 1], [0, 2], [2, 1], [4], [3, 5], [4], [7], [6]]
    dg, cdg = (c.create_dist_graph_adjacent(src, dst) for c in (w, cpu))
    z = torch.randn((n, 2, NBR_ELEMS // 2), device="cuda", generator=g)
    timed("dist-graph with duplicate edges neighbor_alltoall", dg, cdg,
          lambda c, b: c.neighbor_alltoall(b), z)
    timed("dist-graph neighbor_allgather", dg, cdg,
          lambda c, b: c.neighbor_allgather(b), x)
    index, edges = [], []
    for r in range(n):
        edges += [(r - 1) % n, (r + 1) % n, (r + 3) % n]
        index.append(len(edges))
    gr, cgr = (c.create_graph(index, edges, reorder=True) for c in (w, cpu))
    check(gr.graph_neighbors(0) == [n - 1, 1, 3], "graph neighbors")
    _close(gr.allreduce(x[:, :1024]).cpu().numpy(),
           np.broadcast_to(x[:, :1024].cpu().double().sum(0).numpy(),
                           (n, 1024)), 1e-5, 1e-5, "reordered graph allreduce")
    timed("graph (reorder=True) neighbor_allgather", gr, cgr,
          lambda c, b: c.neighbor_allgather(b), x)
    per = [x[r, :(r + 1) * (NBR_ELEMS // n)] for r in range(n)]
    timed("cart neighbor_allgatherv (1-8 MB per rank)", cart, ccart,
          lambda c, b: c.neighbor_allgatherv(b), per)
    rows = [[x[r, :((r + j) % 4 + 1) * (NBR_ELEMS // 16)]
             for j in range(4)] for r in range(n)]
    timed("cart neighbor_alltoallv (up to 5 MB per rank)", cart, ccart,
          lambda c, b: c.neighbor_alltoallv(b), rows)
    phase("topology", "device = host path = CPU port bit for bit, every "
          "output on cuda:0; device ms (CUDA events, median of 10), bytes "
          "= the rows received read once (at most the input) and the "
          "output written once: "
          + "; ".join(lines) + f" | {smi}")


def _algebra(w) -> None:
    n = w.size
    shared = w.split_type(MPI.COMM_TYPE_SHARED)
    check(all(s is shared[0] for s in shared) and shared[0].size == n,
          "split_type SHARED")
    hw = w.split_type(MPI.COMM_TYPE_HWTHREAD)
    check(all(s.size == 1 for s in hw), "split_type HWTHREAD")
    check(w.split_type(MPI.UNDEFINED) == [None] * n, "split_type UNDEFINED")
    sub = w.create(w.group.incl([1, 4, 6]))
    res = sub.allreduce(sub.alloc((3,), fill=2.0), MPI.SUM)
    check(res.is_cuda and bool((res == 6).all()), "create + allreduce")
    trace = []
    kv = MPI.create_keyval(copy_fn=lambda c, k, v: (True, v + 1),
                           delete_fn=lambda c, k, v: trace.append(v))
    w.set_attr(kv, 10)
    d = w.dup()
    check(d.get_attr(kv) == (True, 11), "attribute through dup")
    d.free()
    w.delete_attr(kv)
    MPI.free_keyval(kv)
    check(trace == [11, 10], f"delete callbacks {trace}")
    phase("algebra", "split_type SHARED (one comm of 8), HWTHREAD (8 of "
          "1), UNDEFINED (COMM_NULL); create over ranks 1, 4, 6 with an "
          "allreduce on the card; an attribute copied through dup and "
          "deleted at free and delete_attr")


def phase_ptp_topo_datatype(w, smi: str) -> None:
    """Point-to-point, derived datatypes, topologies and communicator
    algebra on the 8-rank cuda:0 world, against numpy and the CPU port."""
    t0 = time.perf_counter()
    n = w.size
    cpu = MPI.Communicator(MPI.Group(range(n)), [torch.device("cpu")] * n,
                           name="cpu_world")
    _ptp(w, cpu, smi)
    torch.cuda.empty_cache()
    _datatypes(w, cpu, smi)
    torch.cuda.empty_cache()
    _topologies(w, cpu, smi)
    _algebra(w)
    phase("ptp", f"phase 10 took {time.perf_counter() - t0:.1f} s")


# -- phase 11 ----------------------------------------------------------
PR_RANKS = 8
PR_SEED = 1100
PR_TIMEOUT = 300               # seconds the per-rank job may take


def _pr_inputs(n: int) -> list:
    """Every rank's 32 MB fp32 input, made from the seed by every rank,
    so each can hold its results against numpy."""
    return [np.random.default_rng(PR_SEED + j).random(LOCAL_ELEMS,
                                                      dtype=np.float32)
            for j in range(n)]


def _pr_timed(fn, iters: int = 5):
    """(result, median device ms from CUDA events, median host µs) of one
    collective call. The device tier fences through the host, so the
    events span the whole call: the device ms include the fences."""
    res = fn()
    dev, host = [], []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e6)
        dev.append(start.elapsed_time(end))
    return res, statistics.median(dev), statistics.median(host)


def _perrank_rank(report: str) -> int:
    """The rank program of phase 11 (run by mpirun --per-rank); rank 0
    writes its lines to ``report``."""
    from ompi_tpu_torch.core import rankcomm
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = torch.device("cuda", 0)
    check(w.device == dev, f"rank {r} bound to {w.device}")
    lines = []
    total_mb = n * LOCAL_ELEMS * 4 / 1e6

    def on_card(t, what):
        check(isinstance(t, torch.Tensor) and t.device == dev,
              f"rank {r}: {what} is not a CUDA tensor on cuda:0")
        return t.cpu().numpy()

    def share(mb, ms):
        return f"{mb / ms / 1e3 / (HBM_BYTES_PER_S / 1e12):.1%}"

    xs = _pr_inputs(n)
    per = LOCAL_ELEMS // n
    x = torch.from_numpy(xs[r]).to(dev)
    xp = torch.from_numpy(0.5 + xs[r]).to(dev)
    xi = torch.from_numpy((xs[r] * 1000).astype(np.int32)).to(dev)
    stack = np.stack(xs).astype(np.float64)
    cases = [
        ("allreduce SUM f32", lambda: w.allreduce(x, MPI.SUM),
         stack.sum(0), 1e-5),
        ("allreduce MAX f32", lambda: w.allreduce(x, MPI.MAX),
         stack.max(0), 0),
        ("allreduce PROD f32", lambda: w.allreduce(xp, MPI.PROD),
         (0.5 + stack).prod(0), 1e-5),
        ("allreduce SUM i32", lambda: w.allreduce(xi, MPI.SUM),
         np.stack([(a * 1000).astype(np.int32) for a in xs]).sum(0), 0),
    ]
    for name, fn, want, rtol in cases:
        y, ms, us = _pr_timed(fn)
        got = on_card(y, name)
        if rtol:
            ok = np.allclose(got, want, rtol=rtol, atol=1e-6)
        else:
            ok = np.array_equal(got, want)
        check(ok, f"rank {r}: {name} differs from numpy (max abs err "
              f"{np.max(np.abs(got - want)):.3g})")
        lines.append(f"{name}: {ms:.3f} ms call, {us:.0f} us host per "
                     f"dispatch ({share(2 * total_mb, ms)} of HBM for "
                     f"{2 * total_mb:.0f} MB in+out over 8 ranks)")
    # a pair op: chunks of the reduce-scatter read hold whole records
    for recs in (9, 1 << 20):
        pr = [np.stack([np.round(a[:recs] * 4), j * recs + np.arange(recs)],
                       -1).astype(np.float32) for j, a in enumerate(xs)]
        want = pr[0]
        for q in pr[1:]:
            take = (q[:, 0] > want[:, 0]) | ((q[:, 0] == want[:, 0])
                                             & (q[:, 1] < want[:, 1]))
            want = np.where(take[:, None], q, want)
        xl = torch.from_numpy(pr[r]).to(dev)
        y, ms, us = _pr_timed(lambda: w.allreduce(xl, MPI.MAXLOC))
        check(np.array_equal(on_card(y, "allreduce MAXLOC"), want),
              f"rank {r}: allreduce MAXLOC on {recs} records differs")
    lines.append(f"allreduce MAXLOC f32, {recs} (value, index) records: "
                 f"{ms:.3f} ms call, {us:.0f} us host per dispatch")
    y, ms, us = _pr_timed(lambda: w.bcast(x if r == 3 else
                                          torch.empty_like(x), 3))
    check(np.array_equal(on_card(y, "bcast"), xs[3]), f"rank {r}: bcast")
    lines.append(f"bcast root 3: {ms:.3f} ms call, {us:.0f} us host")
    rows, ms, us = _pr_timed(lambda: w.allgather(x), iters=3)
    for j in range(n):
        check(np.array_equal(on_card(rows[j], "allgather"), xs[j]),
              f"rank {r}: allgather row {j}")
    del rows
    lines.append(f"allgather: {ms:.3f} ms call, {us:.0f} us host "
                 f"({share(total_mb * (1 + n), ms)} of HBM)")
    chunks = list(x.view(n, per).unbind(0))
    got, ms, us = _pr_timed(lambda: w.alltoall(chunks))
    for j in range(n):
        check(np.array_equal(on_card(got[j], "alltoall"),
                             xs[j][r * per:(r + 1) * per]),
              f"rank {r}: alltoall chunk {j}")
    lines.append(f"alltoall: {ms:.3f} ms call, {us:.0f} us host "
                 f"({share(2 * total_mb, ms)} of HBM)")
    y, ms, us = _pr_timed(lambda: w.reduce_scatter_block(chunks, MPI.SUM))
    check(np.allclose(on_card(y, "reduce_scatter_block"),
                      stack[:, r * per:(r + 1) * per].sum(0), rtol=1e-5,
                      atol=1e-6), f"rank {r}: reduce_scatter_block")
    lines.append(f"reduce_scatter_block (alltoall + host fold): {ms:.3f} ms"
                 f" call, {us:.0f} us host")

    # numpy staged onto the device tier
    from ompi_tpu_torch.mca import var
    var.var_set("coll_tuned_stage_min_bytes", 1 << 20)
    staged0 = rankcomm.counters["coll_staged_device"]
    h = xs[r][:1 << 20]
    y, ms, us = _pr_timed(lambda: w.allreduce(h, MPI.SUM), iters=3)
    check(isinstance(y, np.ndarray) and np.allclose(
        y, stack[:, :1 << 20].sum(0), rtol=1e-5, atol=1e-6),
        f"rank {r}: staged allreduce")
    check(rankcomm.counters["coll_staged_device"] == staged0 + 4,
          f"rank {r}: numpy allreduce not staged")
    lines.append(f"staged numpy allreduce (4 MB, stage min 1 MiB): "
                 f"{us:.0f} us host")

    # host tier at 37 elements
    small = [a[:37].astype(np.float64) for a in xs]
    check(np.allclose(w.allreduce(small[r], MPI.SUM),
                      np.sum(small, 0), rtol=1e-12), "host allreduce")
    check(np.array_equal(w.bcast(small[r] if r == 0 else None, 0),
                         small[0]), "host bcast")
    check(all(np.array_equal(a, b) for a, b in
              zip(w.allgather(small[r]), small)), "host allgather")
    got = w.alltoall([small[r] + j for j in range(n)])
    check(all(np.array_equal(got[j], small[j] + r) for j in range(n)),
          "host alltoall")
    red = w.reduce(small[r], MPI.MAX, root=1)
    check(red is None if r != 1 else np.array_equal(red, np.max(small, 0)),
          "host reduce")
    check(np.allclose(w.scan(small[r], MPI.SUM),
                      np.sum(small[:r + 1], 0), rtol=1e-12), "host scan")

    # devxfer ring of eight 32 MB CUDA messages
    right, left = (r + 1) % n, (r - 1) % n
    # a 2 MB message first: the 32 MB ring then replaces its send slot,
    # and the receiver drops the stale mapping
    got = w.sendrecv(x[:1 << 19], right, left)[0]
    check(np.array_equal(on_card(got, "devxfer 2 MB"), xs[left][:1 << 19]),
          f"rank {r}: devxfer 2 MB")
    recv0 = w.router.xfer.stats["received"]

    def ring():
        buf = x.clone()
        req = w.irecv(left, tag=11)
        w.send(buf, right, tag=11)
        buf.fill_(-1.0)                 # the sender overwrites its buffer
        return req.get()
    w.barrier()
    z, ms, us = _pr_timed(ring, iters=3)
    check(np.array_equal(on_card(z, "devxfer ring"), xs[left]),
          f"rank {r}: devxfer message changed after its sender's overwrite")
    check(w.router.xfer.stats["received"] == recv0 + 4,
          f"rank {r}: ring did not ride devxfer")
    lines.append(f"devxfer ring, 8 x 32 MB: {ms:.3f} ms call, {us:.0f} "
                 f"us host per round ({share(2 * total_mb, ms)} of HBM "
                 f"for each message read and written once)")

    # the host barrier each device-tier fence waits on
    _, _, bar_us = _pr_timed(w.barrier, iters=20)
    lines.append(f"barrier (3-round dissemination over tcp): {bar_us:.0f} "
                 f"us host; a device collective waits on two of them")

    # 8 B send+recv and a wildcard match
    w.barrier()
    b8 = np.zeros(1, np.float64)
    reps = 200
    if r in (0, 1):
        t0 = time.perf_counter()
        for _ in range(reps):
            if r == 0:
                w.send(b8, 1, tag=5)
                w.recv(1, tag=5)
            else:
                w.recv(0, tag=5)
                w.send(b8, 0, tag=5)
        rt_us = (time.perf_counter() - t0) / reps * 1e6
        if r == 1:
            for i in range(256):
                w.send(np.array([i]), 0, tag=100 + i % 7)
            w.send(b8, 0, tag=999)
        else:
            w.recv(1, tag=999)            # the 256 are queued before it
            t0 = time.perf_counter()
            seen = sorted(int(w.recv(MPI.ANY_SOURCE, MPI.ANY_TAG)[0][0])
                          for _ in range(256))
            wild_us = (time.perf_counter() - t0) / 256 * 1e6
            check(seen == list(range(256)), "wildcard matches")
            lines.append(f"8 B send+recv round trip (ranks 0 and 1): "
                         f"{rt_us:.1f} us host ({rt_us / 2:.1f} us per "
                         f"8 B pair); ANY_SOURCE/ANY_TAG match with 256 "
                         f"queued: {wild_us:.1f} us per match")
    w.barrier()

    # split into two comms of 4
    sub = w.split(r % 2, key=r)
    check(sub.size == 4 and sub.rank() == r // 2, "split")
    members = [j for j in range(n) if j % 2 == r % 2]
    for elems in (1 << 18, 1 << 21):    # the second grows the slots
        s_got = on_card(sub.allreduce(x[:elems], MPI.SUM),
                        "split allreduce")
        check(np.allclose(s_got, stack[members, :elems].sum(0), rtol=1e-5,
                          atol=1e-6), f"rank {r}: split allreduce")
    sub.free()
    MPI.Finalize()
    if r == 0:
        with open(report, "w") as f:
            json.dump(lines, f)
    print(f"OK perrank rank={r}/{n}", flush=True)
    return 0


def phase_perrank(smi: str) -> None:
    """Launch the per-rank job and relay rank 0's lines."""
    import tempfile
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "rank0.json")
        cmd = [sys.executable,
               os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py"),
               "--per-rank", "-n", str(PR_RANKS), "--timeout",
               str(PR_TIMEOUT), os.path.abspath(__file__), "--perrank-rank",
               report]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=PR_TIMEOUT + 60, cwd=root)
        oks = res.stdout.count("OK perrank")
        if res.returncode != 0 or oks != PR_RANKS:
            sys.stderr.write(res.stderr[-6000:])
            check(False, f"per-rank job rc={res.returncode}, {oks} of "
                  f"{PR_RANKS} ranks OK:\n{res.stdout[-3000:]}")
        with open(report) as f:
            lines = json.load(f)
    for line in lines:
        phase("perrank", f"{line} | {smi}")
        m = re.match(r"([^:]+): ([0-9.]+) ms", line)
        if m:
            COLL_MS[("p11", m.group(1))] = float(m.group(2))
    phase("perrank", "'ms call' is a CUDA-event span on rank 0's stream "
          "that includes the host fences; 'of HBM' divides bytes by it")
    phase("perrank", f"8 rank processes on cuda:0, every result = numpy "
          f"on every rank (float SUM/PROD rtol 1e-5, the rest exact), "
          f"every device result on cuda:0; phase 11 took "
          f"{time.perf_counter() - t0:.1f} s | {smi}")


DP_SEED = 1200


def _dp_timed(fn, iters: int = 3):
    """(last result, median host ms) of a host-tier call."""
    res, ts = fn(), []
    for _ in range(iters):
        t0 = time.perf_counter()
        res = fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return res, statistics.median(ts)


def _same_everywhere(w, arr) -> bool:
    """Every rank holds the same bits of ``arr`` (a digest allgather)."""
    import hashlib
    digest = hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()
    return len(set(w.allgather(digest))) == 1


def _dataplane_rank(report: str) -> int:
    """The rank program of phase 12 (run by mpirun --per-rank). Rank 0
    writes its lines to ``report``."""
    from ompi_tpu_torch.btl import shmseg
    from ompi_tpu_torch.coll import tuned
    from ompi_tpu_torch.core import rankcomm
    from ompi_tpu_torch.pml import pipeline
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = torch.device("cuda", 0)
    check(w.device == dev, f"rank {r} bound to {w.device}")
    c = rankcomm.counters
    lines = []
    # the staging probe rank 0 ran on the card at Init
    basis = tuned.probed_stage_basis()
    check(basis.get("ran") and basis.get("device") == "cuda",
          f"rank {r}: stage probe basis {basis}")
    vals = w.allgather(int(basis["value"]))
    check(len(set(vals)) == 1, f"stage probe values differ: {vals}")
    lines.append(
        f"stage probe (rank 0 on cuda:0, adopted by all {n} ranks): "
        f"staged {basis['staged_per_mb_ms']} ms/MB + "
        f"{basis['staged_fixed_us']} us fixed, host "
        f"{basis['host_per_mb_ms']} ms/MB + {basis['host_fixed_us']} us "
        f"fixed (transport {basis.get('transport_gbps')} GB/s); "
        f"confirmed at {basis.get('confirm_bytes')} B: staged "
        f"{basis.get('confirm_staged_ms')} ms against host "
        f"{basis.get('confirm_host_ms')} ms; adopted stage_min_bytes "
        f"{basis['stage_min_bytes']}")
    var.var_set("coll_tuned_stage_min_bytes", 1 << 62)     # host tier
    xs = _pr_inputs(n)
    stack = np.stack(xs)
    xi = (xs[r] * 1000).astype(np.int32)
    mb = LOCAL_ELEMS * 4 >> 20

    # the pipelined ring and chain over 1 and 2 rails, in turns
    s0, i0 = (pvar.pvar_read("pml_pipeline_segments"),
              pvar.pvar_read("pml_pipeline_inits"))
    ring0 = c["coll_pipelined_ring"]
    ring_ms, chain_ms, overlap = {1: [], 2: []}, {1: [], 2: []}, {}
    for rails in (1, 2, 2, 1):
        var.var_set("mpi_base_btl_rails", rails)
        before = [pvar.pvar_read(f"btl_rail_bytes_c{k}") for k in (0, 1)]
        y, ms = _dp_timed(lambda: w.allreduce(xs[r], MPI.SUM), iters=1)
        ring_ms[rails].append(ms)
        overlap[rails] = pvar.pvar_read("pml_overlap_ratio")
        b, ms = _dp_timed(lambda: w.bcast(xs[0] if r == 0 else None, 0),
                          iters=1)
        chain_ms[rails].append(ms)
        # a rank that is done early may already send the next turn's
        # segments: the counters are read between two barriers
        w.barrier()
        grew = [pvar.pvar_read(f"btl_rail_bytes_c{k}") - before[k]
                for k in (0, 1)]
        w.barrier()
        check(grew[0] > 0 and (grew[1] > 0) == (rails == 2),
              f"rank {r}: rails {rails} carried {grew} bytes")
    check(np.allclose(y, stack.astype(np.float64).sum(0), rtol=1e-5,
                      atol=1e-6), f"rank {r}: pipelined ring SUM")
    check(_same_everywhere(w, y), "pipelined ring SUM: ranks differ")
    check(np.array_equal(b, xs[0]), f"rank {r}: chain bcast")
    ring_sum = y
    ym, ms_max = _dp_timed(lambda: w.allreduce(xs[r], MPI.MAX), iters=1)
    check(np.array_equal(ym, stack.max(0)), f"rank {r}: ring MAX f32")
    yi, _ = _dp_timed(lambda: w.allreduce(xi, MPI.MAX), iters=1)
    check(np.array_equal(yi, np.stack([(a * 1000).astype(np.int32)
                                       for a in xs]).max(0)),
          f"rank {r}: ring MAX i32")
    check(_same_everywhere(w, yi), "pipelined ring MAX i32: ranks differ")
    check(c["coll_pipelined_ring"] - ring0 == 12,
          f"rank {r}: the ring did not run every call")
    check(c["coll_pipelined_chain"] == 8, f"rank {r}: chain did not run")
    segs = pvar.pvar_read("pml_pipeline_segments") - s0
    inits = pvar.pvar_read("pml_pipeline_inits") - i0
    per_rail = [pvar.pvar_read(f"btl_rail_bytes_c{k}") for k in (0, 1)]
    for rails in (1, 2):
        lines.append(
            f"pipelined ring allreduce SUM, {mb} MB f32 per rank, rails "
            f"{rails}: {ring_ms[rails][0]:.1f} / {ring_ms[rails][1]:.1f} ms "
            f"per call (host clock, runs in turns 1 2 2 1), "
            f"pml_overlap_ratio {overlap[rails]}; chain bcast "
            f"{chain_ms[rails][0]:.1f} / {chain_ms[rails][1]:.1f} ms")
    lines.append(f"pipelined ring MAX f32 (rails 1): {ms_max:.1f} ms; "
                 f"{segs / max(inits, 1):.1f} segments per train; bytes "
                 f"per rail {per_rail}")

    # the in-segment fold against the ring, and pt2pt adoption
    var.var_set("mpi_base_shm_zerocopy", True)
    f0 = c["coll_shm_fold"]
    yf, ms_fold = _dp_timed(lambda: w.allreduce(xs[r], MPI.SUM))
    check(np.allclose(yf, ring_sum, rtol=1e-5, atol=1e-6),
          f"rank {r}: fold SUM against the ring")
    ymf, _ = _dp_timed(lambda: w.allreduce(xs[r], MPI.MAX), iters=1)
    check(np.array_equal(ymf, ym), f"rank {r}: fold MAX against the ring")
    check(_same_everywhere(w, yf), "fold SUM: ranks differ")
    check(c["coll_shm_fold"] - f0 == 6, f"rank {r}: the fold did not run")
    right, left = (r + 1) % n, (r - 1) % n
    a0, p0 = (pvar.pvar_read("btl_shm_adoptions"),
              pvar.pvar_read("btl_shm_seg_packs"))
    w.barrier()                  # no message lands before the counts
    req = w.irecv(left, tag=21)
    w.send(xs[r], right, tag=21)
    got = req.get()
    check(np.array_equal(got, xs[left]), f"rank {r}: zero-copy pt2pt")
    del got
    check(pvar.pvar_read("btl_shm_adoptions") - a0 == 1 and
          pvar.pvar_read("btl_shm_seg_packs") - p0 == 1,
          f"rank {r}: pt2pt did not ride the shared segment "
          f"({pvar.pvar_read('btl_shm_adoptions') - a0} adoptions, "
          f"{pvar.pvar_read('btl_shm_seg_packs') - p0} packs)")
    var.var_set("mpi_base_shm_zerocopy", False)
    w.barrier()
    ring_med = statistics.median(ring_ms[1] + ring_ms[2])
    lines.append(f"in-segment fold SUM, {mb} MB f32 per rank: "
                 f"{ms_fold:.1f} ms per fold (host clock) against the "
                 f"pipelined ring's {ring_med:.1f} (median of the four "
                 f"turns); MAX bit for bit, SUM "
                 f"rtol 1e-5; pt2pt adopted in place (btl_shm_adoptions "
                 f"+1, btl_shm_seg_packs +1 on every rank)")

    # a CUDA tensor through the pipeline, against the devxfer ring
    x = torch.from_numpy(xs[r]).to(dev)

    def ring(tag):
        buf = x.clone()
        q = w.irecv(left, tag=tag)
        w.send(buf, right, tag=tag)
        buf.fill_(-1.0)                  # the sender overwrites its buffer
        return q.get()
    var.var_set("btl_devxfer_min_bytes", 1 << 40)
    st0, recv0 = pipeline.stats["staged"], w.router.xfer.stats["received"]
    w.barrier()
    z, ms_pipe = _dp_timed(lambda: ring(31))
    # a CUDA payload arrives as numpy, as on the eager path
    check(np.array_equal(z if isinstance(z, np.ndarray) else z.numpy(),
                         xs[left]),
          f"rank {r}: pipelined CUDA message changed")
    staged = pipeline.stats["staged"] - st0
    check(staged > 0 and w.router.xfer.stats["received"] == recv0,
          f"rank {r}: the CUDA tensor did not go through SegmentStager")
    var.var_set("btl_devxfer_min_bytes", 1 << 20)
    w.barrier()
    zd, ms_xfer = _dp_timed(lambda: ring(32))
    check(np.array_equal(zd.cpu().numpy(), xs[left]),
          f"rank {r}: devxfer message changed")
    lines.append(f"CUDA tensor ring, 8 x {mb} MB, devxfer declined: "
                 f"{ms_pipe:.1f} ms per message through SegmentStager "
                 f"({staged // 4} segments staged per message) against "
                 f"{ms_xfer:.1f} ms through devxfer in the same job (host "
                 f"clock, median of 3)")

    # compressed host hops, with the pipeline off so the bcast takes the
    # compressed tree, not the chain
    full = np.stack([a[:1 << 19] for a in xs])           # 2 MB per rank
    mine = full[r]
    ref = full.astype(np.float64).sum(0)
    sub = w.split(r // 4, key=r)                        # two comms of 4
    members = [j for j in range(n) if j // 4 == r // 4]
    sub_ref = full[members].astype(np.float64).sum(0)
    var.var_set("mpi_base_pipeline_enable", False)
    var.var_set("mpi_base_compress", True)
    var.var_set("mpi_base_compress_min_bytes", 1 << 20)
    ratios = []
    for codec in ("int8_block", "fp8_block"):
        var.var_set("mpi_base_compress_codec", codec)
        scale = ENVELOPE_SCALE[codec]
        d0 = c["coll_compress_direct"]
        bi0 = pvar.pvar_read("compress_bytes_in")
        bo0 = pvar.pvar_read("compress_bytes_out")
        ya = sub.allreduce(mine, MPI.SUM)
        check(c["coll_compress_direct"] == d0 + 1,
              f"rank {r}: {codec} direct allreduce did not run")
        check(np.abs(ya - sub_ref).max() <= 0.02 * np.abs(sub_ref).max()
              * scale, f"rank {r}: {codec} direct allreduce envelope")
        check(_same_everywhere(sub, ya), f"{codec} direct: ranks differ")
        red = w.reduce(mine, MPI.SUM, root=2)
        if r == 2:
            check(np.abs(red - ref).max() <= 0.02 * np.abs(ref).max()
                  * scale, f"{codec} reduce envelope")
        bc = w.bcast(mine if r == 5 else None, 5)
        check(np.abs(bc - full[5]).max() <= np.abs(full[5]).max() / 64
              * scale, f"rank {r}: {codec} bcast envelope")
        import hashlib
        digests = w.allgather(hashlib.sha1(bc.tobytes()).hexdigest())
        check(len({d for j, d in enumerate(digests) if j != 5}) == 1,
              f"{codec} bcast: the receiving ranks differ")
        ratios.append(
            (pvar.pvar_read("compress_bytes_out") - bo0)
            / max(pvar.pvar_read("compress_bytes_in") - bi0, 1))
        lines.append(f"compressed host hops {codec}, 2 MB f32 per rank: "
                     f"direct allreduce (comms of 4), reduce and bcast "
                     f"within the envelope x{scale:.3g}; wire ratio "
                     f"{ratios[-1]:.4f} (compress_ratio pvar "
                     f"{pvar.pvar_read('compress_ratio'):.4f})")
    var.var_set("mpi_base_compress", False)
    var.var_set("mpi_base_pipeline_enable", True)
    sub.free()

    # persistent plans on the per-rank tier
    def per_call_us(fn, reps=200):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    pd = w.allreduce_init(x, MPI.SUM)
    check(pd.plan.algorithm == "generic", f"device plan {pd.plan.algorithm}")
    pd.start()
    pd.wait()
    check(torch.equal(pd.get(), w.allreduce(x, MPI.SUM)),
          f"rank {r}: device-tier plan differs from the one-shot call")
    var.var_set("coll_tuned_stage_min_bytes", 1 << 20)
    h = xs[r][:1 << 20].copy()
    ps = w.allreduce_init(h, MPI.SUM)
    check(ps.plan.algorithm == "staged_device",
          f"staged plan {ps.plan.algorithm}")
    check(accelerator.current_module().is_host_registered(h),
          "the staged plan's buffer is not registered")
    ps.start()
    ps.wait()
    check(np.array_equal(ps.get(), w.allreduce(h, MPI.SUM)),
          f"rank {r}: staged plan differs from the one-shot call")
    b8 = np.full(1, float(r + 1))
    p8 = w.allreduce_init(b8, MPI.SUM)
    check(p8.plan.algorithm == "small_combine",
          f"8 B plan {p8.plan.algorithm}")

    def start_wait():
        p8.start()
        p8.wait()
    w.barrier()
    sw_us = per_call_us(start_wait)
    w.barrier()
    one_us = per_call_us(lambda: w.allreduce(b8, MPI.SUM))
    check(p8.get()[0] == w.allreduce(b8, MPI.SUM)[0] == n * (n + 1) / 2,
          f"rank {r}: 8 B plan")
    var.var_set("mpi_base_bucket", True)
    leaves = [np.full(64 + j, float(j + r), np.float32) for j in range(14)]
    plans = [w.allreduce_init(leaf, MPI.SUM) for leaf in leaves]
    fl0 = pvar.pvar_read("coll_bucket_flushes")
    MPI.Startall(plans)
    outs = [q.get() for q in plans]
    flushes = pvar.pvar_read("coll_bucket_flushes") - fl0
    var.var_set("mpi_base_bucket", False)
    for leaf, out in zip(leaves, outs):
        check(np.array_equal(out, w.allreduce(leaf, MPI.SUM)),
              f"rank {r}: bucketed plan differs")
    check(1 <= flushes < 14, f"rank {r}: {flushes} flushes for 14 plans")
    lines.append(f"persistent plans: device tier (generic), staged numpy "
                 f"on pinned pages (staged_device), 8 B (small_combine) "
                 f"bit for bit against the one-shot calls; 8 B "
                 f"Start+Wait {sw_us:.1f} us against {one_us:.1f} us per "
                 f"one-shot allreduce (host clock, 200 calls); Startall "
                 f"over 14 plans: {flushes} fused flush(es)")
    MPI.Finalize()
    if r == 0:
        with open(report, "w") as f:
            json.dump(lines, f)
    print(f"OK dataplane rank={r}/{n}", flush=True)
    return 0


def _tuned_single(w, smi: str) -> None:
    """The tuned component on the single-controller world: a numpy
    (8, 1 MiB fp32) stack returns numpy equal to coll/torch on the same
    tensor, staged (bit for bit) and on the host (rtol 1e-5)."""
    x = np.random.default_rng(DP_SEED).standard_normal(
        (w.size, 1 << 18)).astype(np.float32)
    mod = w._coll("allreduce")
    check(w._coll_winners["allreduce"] == "tuned", "tuned did not win")
    want = mod.device.allreduce(torch.from_numpy(x).to("cuda"),
                                MPI.SUM).cpu().numpy()
    y = w.allreduce(x, MPI.SUM)          # the probe-earned route
    from ompi_tpu_torch.coll import tuned
    basis = tuned.probed_stage_basis()
    check(isinstance(y, np.ndarray) and basis.get("device") == "cuda",
          f"numpy in gave {type(y)}; probe {basis}")
    times = {}
    for route, smin in (("staged", 0), ("host", 1 << 62)):
        var.var_set("coll_tuned_stage_min_bytes", smin)
        got = w.allreduce(x, MPI.SUM)
        check(isinstance(got, np.ndarray), f"{route}: {type(got)}")
        if route == "staged":
            check(np.array_equal(got, want), "staged: differs from "
                  "coll/torch on the same tensor")
        else:
            check(np.allclose(got, want, rtol=1e-5, atol=1e-5),
                  "host: differs from coll/torch on the same tensor")
        times[route] = host_ms(lambda: w.allreduce(x, MPI.SUM))
    phase("dataplane", f"tuned: numpy (8, 1 MiB f32) allreduce returns "
          f"numpy = coll/torch; staged {times['staged']:.3f} ms, host "
          f"{times['host']:.3f} ms (host clock); the single-controller "
          f"probe: staged {basis.get('staged_per_mb_ms')} ms/MB against "
          f"host {basis.get('host_per_mb_ms')} ms/MB, stage_min_bytes "
          f"{basis.get('stage_min_bytes')} (-1: never stage) | {smi}")


def _run_job(rank_flag: str, mca) -> list:
    """Launch 8 rank processes of this script and return rank 0's
    lines."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "rank0.json")
        cmd = [sys.executable,
               os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py"),
               "--per-rank", "-n", str(PR_RANKS), "--timeout",
               str(PR_TIMEOUT)]
        for k, v in mca:
            cmd += ["--mca", k, str(v)]
        cmd += [os.path.abspath(__file__), rank_flag, report]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=PR_TIMEOUT + 60, cwd=root)
        oks = res.stdout.count("OK ")
        if res.returncode != 0 or oks != PR_RANKS:
            sys.stderr.write(res.stderr[-6000:])
            check(False, f"per-rank job rc={res.returncode}, {oks} "
                  f"of {PR_RANKS} ranks OK:\n{res.stdout[-3000:]}")
        with open(report) as f:
            return json.load(f)


def phase_dataplane(smi: str) -> None:
    """The per-rank large-message data plane, 8 rank processes on
    cuda:0."""
    t0 = time.perf_counter()
    lines = _run_job("--dataplane-rank", [("mpi_base_btl_rails", 2),
                                          ("mpi_base_shm_seg_count", 2)])
    for line in lines:
        phase("dataplane", f"{line} | {smi}")
    phase("dataplane", f"8 rank processes on cuda:0, every check passed on "
          f"every rank; phase 12 took {time.perf_counter() - t0:.1f} s "
          f"| {smi}")


# -- phase 13 ----------------------------------------------------------
OBS_SEED = 1300
OBS_COLLS = ("allreduce", "bcast", "reduce", "allgather", "gather",
             "scatter", "alltoall", "reduce_scatter_block", "scan",
             "barrier")


def _obs_args(w, func, x):
    """The arguments of one call of ``func`` on the stacked ``x``."""
    n = w.size
    return {"allreduce": (x, MPI.SUM), "bcast": (x, 3),
            "reduce": (x, MPI.SUM, 2), "allgather": (x,),
            "gather": (x, 1), "scatter": (x, 4),
            "alltoall": (x.view(n, n, -1),),
            "reduce_scatter_block": (x.view(n, n, -1), MPI.SUM),
            "scan": (x, MPI.SUM), "barrier": ()}[func]


def _obs_same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return bool(torch.equal(a, b))


def _obs_8b_us(comm, calls: int = 2000) -> float:
    """Host µs per 8 B allreduce on ``comm`` (synchronised at the end)."""
    small = comm.alloc((2,), dtype=torch.float32, fill=1.0)
    comm.allreduce(small, MPI.SUM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        comm.allreduce(small, MPI.SUM)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _obs_tracing(w, dev, elems: int) -> list:
    """13(a): every collective once per round, two rounds, on a dup
    built with monitoring and tracing on, against the same calls on the
    plain world."""
    from ompi_tpu_torch import trace
    from ompi_tpu_torch.coll import monitoring
    from ompi_tpu_torch.runtime import spc
    n = w.size
    g = torch.Generator(device=dev).manual_seed(OBS_SEED)
    x = torch.rand((n, elems), generator=g, device=dev)
    trace.enable()
    trace.reset()
    var.var_set("coll_monitoring_enable", True)
    d = w.dup()
    var.var_set("coll_monitoring_enable", False)
    monitoring.reset()
    spc_before = spc.snapshot()
    for _ in range(2):
        for func in OBS_COLLS:
            args = _obs_args(w, func, x)
            want = getattr(w, func)(*args)
            got = getattr(d, func)(*args)
            check(_obs_same(got, want), f"traced {func} differs from the "
                  f"untraced call")
    torch.cuda.synchronize()
    # the shims' coll_<func> spans, and a coll.body span inside
    # coll/torch_ per call of a collective with a body (every one but
    # barrier) on either comm, since the tracer is armed for both
    every = trace.spans()
    bodies = [s for s in every if s.name == "coll.body"]
    spans = [s for s in every if s.name != "coll.body"]
    for func in OBS_COLLS:
        mine = [s for s in spans if s.name == f"coll_{func}"]
        check([s.seq for s in mine] == [0, 1]
              and all(s.cid == str(d.cid) for s in mine),
              f"coll_{func} spans {[(s.cid, s.seq) for s in mine]}")
    check(all(s.name.startswith("coll_") for s in spans),
          f"unexpected spans {sorted({s.name for s in spans})}")
    check(sorted(s.args["func"] for s in bodies)
          == sorted([f for f in OBS_COLLS if f != "barrier"] * 4),
          f"coll.body spans {sorted(s.args['func'] for s in bodies)}")
    export = json.loads(json.dumps(trace.perfetto.export(spans)))
    check(len([e for e in export["traceEvents"] if e["ph"] == "X"])
          == 2 * len(OBS_COLLS), "perfetto export")
    snap = monitoring.snapshot()
    for func in OBS_COLLS:
        args = _obs_args(w, func, x)
        nbytes = args[0].nbytes if args else 0
        check(snap.get((d.cid, func)) == (2, 2 * nbytes),
              f"monitoring {func}: {snap.get((d.cid, func))}")
    spc_after = spc.snapshot()
    for func in OBS_COLLS:
        key = f"coll_{func}"
        check(spc_after.get(key, 0) - spc_before.get(key, 0) == 4,
              f"spc {key}: {spc_after.get(key, 0) - spc_before.get(key, 0)}"
              f" for 4 calls")
    lines = [f"tracing: 10 collectives x 2 rounds at {elems * 4 >> 20} MB "
             f"fp32 per rank on a dup with monitoring and tracing on = the "
             f"plain world bit for bit; one coll_<func> span per call, cid "
             f"{d.cid}, seq 0, 1, and one coll.body per call but barrier's "
             f"on either comm; Perfetto export loads as JSON; monitoring "
             f"bytes = payloads; SPC coll_<func> +4 per function (2 traced, "
             f"2 untraced calls)"]
    d.free()
    # a small ring under many calls: drops are counted, never block
    trace.enable(capacity=64)
    dt = w.dup()
    small = dt.alloc((2,), dtype=torch.float32, fill=1.0)
    for _ in range(1000):
        dt.allreduce(small, MPI.SUM)
    st = trace.stats()
    # two spans a call: the shim's coll_allreduce and coll.body
    check(st["spans"] == 64 and st["dropped"] == 1936
          and pvar.pvar_read("trace_dropped") == 1936,
          f"ring of 64 under 1000 calls: {st}")
    lines.append(f"ring of 64 under 1000 allreduces (2 spans each): "
                 f"trace_spans "
                 f"{pvar.pvar_read('trace_spans')}, trace_dropped "
                 f"{pvar.pvar_read('trace_dropped')}")
    # host µs per 8 B allreduce, tracing off (the plain world, unwrapped,
    # with the tracer disarmed) and on (the traced dup), in turns a b b a
    us = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        if mode == "off":
            trace.disable()
        else:
            trace.enable(capacity=1 << 16)
        trace.reset()
        us[mode].append(_obs_8b_us(w if mode == "off" else dt))
    dt.free()
    trace.disable()
    trace.reset()
    lines.append("8 B allreduce host us/call, tracing off then on, in "
                 "turns (off on on off): "
                 + ", ".join(f"{u:.2f}" for u in (us["off"][0], *us["on"],
                                                   us["off"][1])))
    # host µs per 8 B allreduce on the plain world with the SPC counters
    # off and on (``mpi_base_spc_enable``; tracing off), in turns a b b a.
    # spc.reset() makes record() read the switch again.
    spc_us = {False: [], True: []}
    try:
        for on in (False, True, True, False):
            var.var_set("mpi_base_spc_enable", on)
            spc.reset()
            spc_us[on].append(_obs_8b_us(w))
    finally:
        var.var_set("mpi_base_spc_enable", True)
        spc.reset()
    lines.append("8 B allreduce host us/call, SPC off then on, in turns "
                 "(off on on off): "
                 + ", ".join(f"{u:.2f}" for u in (spc_us[False][0],
                                                   *spc_us[True],
                                                   spc_us[False][1])))
    return lines


def _obs_unsigned(w, dev) -> str:
    """13(b): unsigned reductions on the card, on a tensor and on a numpy
    stack staged above stage_min, exact against numpy."""
    n = w.size
    rng = np.random.default_rng(OBS_SEED + 1)
    ops = {"SUM": np.add, "PROD": np.multiply, "MAX": np.maximum,
           "MIN": np.minimum, "BAND": np.bitwise_and}
    cases = 0
    saved = var.var_get("coll_tuned_stage_min_bytes")
    var.var_set("coll_tuned_stage_min_bytes", 4096)
    try:
        for dt in (np.uint16, np.uint32, np.uint64):
            x = rng.integers(0, np.iinfo(dt).max, size=(n, 4096), dtype=dt,
                             endpoint=True)
            for name, fold in ops.items():
                want = np.broadcast_to(fold.reduce(x, 0, dtype=dt), x.shape)
                op = getattr(MPI, name)
                t = w.allreduce(torch.from_numpy(x).to(dev), op)
                check(t.device == dev and t.dtype == torch.from_numpy(x).dtype
                      and np.array_equal(t.cpu().numpy(), want),
                      f"{name} {np.dtype(dt).name} tensor on the card")
                h = w.allreduce(x.copy(), op)
                check(isinstance(h, np.ndarray) and h.dtype == dt
                      and np.array_equal(h, want),
                      f"{name} {np.dtype(dt).name} staged numpy")
                cases += 2
    finally:
        var.var_set("coll_tuned_stage_min_bytes", saved)
    return (f"unsigned reductions: uint16/32/64 x SUM, PROD, MAX, MIN, BAND "
            f"on (8, 4096) tensors on {dev} and numpy stacks staged above "
            f"stage_min (4096 B): {cases} cases exact against numpy, "
            f"operand type kept, every tensor result on {dev}")


def _obs_vprotocol(w, dev, elems: int) -> str:
    """13(c): pessimist logging of wildcard receives of CUDA tensors; a
    replay from the JSON snapshot forces the logged order; redelivery
    gives the logged bits after the senders overwrote their buffers."""
    from ompi_tpu_torch.pml import vprotocol
    var.var_set("pml_v_protocol", "pessimist")
    c = w.dup()
    check(isinstance(c._pml, vprotocol.PessimistEngine), "pessimist engine")
    var.var_set("pml_v_protocol", "none")    # the engine is chosen once
    g = torch.Generator(device=dev).manual_seed(OBS_SEED + 2)
    bufs = {s: torch.rand(elems, generator=g, device=dev)
            for s in (1, 2, 3, 4)}
    keep = {s: b.clone() for s, b in bufs.items()}
    # wildcard receives posted first match in arrival order
    reqs = [c.irecv(MPI.ANY_SOURCE, MPI.ANY_TAG, dst=0) for _ in range(4)]
    for s in (3, 1, 4, 2):
        c.send(bufs[s], s, 0, tag=10 + s)
    order = [q.wait().source for q in reqs]
    check(order == [3, 1, 4, 2], f"arrival order {order}")
    for q, s in zip(reqs, order):
        check(q.get().device == dev and torch.equal(q.get(), keep[s]),
              "wildcard payload")
    snap = json.dumps(c._pml.snapshot())
    log = vprotocol.PessimistEngine.restore_log(json.loads(snap))
    check(sum(e.kind == "match" for e in log) == 4, "determinants logged")
    rep = vprotocol.PessimistEngine(c, replay_log=log)
    reqs = [rep.irecv(0, MPI.ANY_SOURCE, MPI.ANY_TAG) for _ in range(4)]
    for s in (2, 4, 1, 3):                   # another arrival order
        rep.send(keep[s], s, 0, 10 + s)
    again = [q.wait().source for q in reqs]
    check(again == order, f"replay order {again} != {order}")
    for b in bufs.values():
        b.fill_(-1.0)                        # the senders reuse buffers
    fresh = vprotocol.PessimistEngine(c, replay_log=log)
    fresh.log = log
    check(fresh.redeliver(0) == 4, "redeliver count")
    for _ in range(4):
        data, st = fresh.recv(0, MPI.ANY_SOURCE, MPI.ANY_TAG)
        check(data.device == dev and torch.equal(data, keep[st.source]),
              "redelivered payload")
    torch.cuda.synchronize()
    c.free()
    return (f"vprotocol pessimist: 4 wildcard receives of {elems * 4 >> 20} "
            f"MiB CUDA tensors logged (order {order}); a replay from the "
            f"JSON snapshot ({len(snap) >> 20} MiB) forced that order; "
            f"redeliver gave the logged bits on {dev} after the senders "
            f"overwrote their buffers")


def _observe_rank(report: str) -> int:
    """The rank program of phase 13 (run by mpirun --per-rank with
    tracing on); rank 0 writes its lines to ``report``."""
    from ompi_tpu_torch import trace
    from ompi_tpu_torch.pml import part_perrank as part
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = w.device
    check(trace.core.active and w._coll_interposers == ["trace"],
          f"rank {r}: tracing not armed ({w._coll_interposers})")
    lines = []
    out_dir = os.path.dirname(report)
    late = 5 if n > 5 else n - 1
    mb = LOCAL_ELEMS * 4 >> 20
    # device-tier allreduce, 32 MB per rank; exact sums whatever the order
    base = (torch.arange(LOCAL_ELEMS, device=dev) % 1024).float()
    x = base + r
    want = base * n + n * (n - 1) / 2
    for i in range(4):
        if i == 2 and r == late:
            time.sleep(0.2)
        got = w.allreduce(x, MPI.SUM)
        check(got.device == dev and torch.equal(got, want),
              f"rank {r}: device allreduce {i}")
    # host-tier pipelined ring, 32 MB per rank
    var.var_set("coll_tuned_stage_min_bytes", 1 << 62)
    xh = (np.arange(LOCAL_ELEMS) % 1024).astype(np.float32) + r
    ring = w.allreduce(xh, MPI.SUM)
    check(np.array_equal(ring, want.cpu().numpy()), f"rank {r}: host ring")
    # coll/sync: a barrier before every 3rd collective changes nothing
    var.var_set("coll_sync_barrier_before", 3)
    ws = w.dup()
    var.var_set("coll_sync_barrier_before", 0)
    check(ws._coll_interposers == ["sync", "trace"], "sync interposer")
    for i in range(7):
        check(torch.equal(ws.allreduce(x, MPI.SUM), want)
              and float(ws.allreduce(np.float64(i), MPI.SUM)) == i * n,
              f"rank {r}: allreduce under coll/sync")
    ws.free()
    # part_perrank: rank 0 sends rank 1 a 32 MB CUDA tensor in 4 parts
    q = LOCAL_ELEMS // 4
    src = torch.rand(LOCAL_ELEMS, generator=torch.Generator(
        device=dev).manual_seed(OBS_SEED + 3), device=dev)
    if r == 0:
        ps = part.psend_init(w, [src[k * q:(k + 1) * q] for k in range(4)],
                             dest=1, tag=9)
    elif r == 1:
        pr = part.precv_init(w, 4, source=0, tag=9)
    polls = 0
    for rnd in range(2):
        if r == 0:
            ps.start()
            for k in (2, 0, 1, 3):
                ps.pready(k)
            ps.wait()
        elif r == 1:
            pr.start()
            polls += 1
            while not all(pr.parrived(k) for k in range(4)):
                polls += 1                   # rounds of parrived polls
            pr.wait(timeout=120)
            got = torch.cat(pr.get())
            check(got.device == dev and torch.equal(got, src * 2 ** rnd),
                  f"partitioned round {rnd}")
        w.barrier()
        if r == 0:
            src.mul_(2.0)        # the sender rewrites its partitions' data
    torch.cuda.synchronize()
    trace.dump(os.path.join(out_dir, f"trace_r{r}.json"))
    names = [s.name for s in trace.spans()]
    counts = {k: names.count(k) for k in
              ("coll_allreduce", "coll_barrier", "pml_send", "pml_recv",
               "pml.segment", "btl.rail")}
    check(counts["coll_allreduce"] == 5 + 14,
          f"rank {r}: coll_allreduce spans {counts['coll_allreduce']}")
    for k in ("pml_send", "pml_recv", "pml.segment", "btl.rail"):
        check(counts[k] > 0, f"rank {r}: no {k} span")
    w.barrier()
    if r == 0:
        spans = []
        for j in range(n):
            spans += trace.load_dump(
                os.path.join(out_dir, f"trace_r{j}.json"))["spans"]
        reps = trace.attribution.late_arrival(spans)
        third = [p for p in reps if p["name"] == "coll_allreduce"
                 and p["cid"] == str(w.cid) and p["seq"] == 2]
        check(len(third) == 1 and third[0]["nranks"] == n
              and third[0]["critical_rank"] == late
              and third[0]["skew_s"] >= 0.15,
              f"attribution of the third allreduce: {third}")
        json.dumps(trace.perfetto.export(spans))
        lines.append(
            f"per-rank job, tracing on: spans on rank 0 {counts}; "
            f"late_arrival names rank {third[0]['critical_rank']} of the "
            f"third {mb} MB device allreduce with skew "
            f"{third[0]['skew_s'] * 1e3:.1f} ms (rank {late} slept 200 ms); "
            f"worst occurrence of the run: {reps[0]['name']} seq "
            f"{reps[0]['seq']} ({reps[0]['skew_s'] * 1e3:.1f} ms)")
        lines.append(f"host ring ({mb} MB per rank) and device allreduces "
                     f"= exact sums; coll_sync_barrier_before=3 left 14 "
                     f"results unchanged; part_perrank {mb} MB tensor in 4 "
                     f"partitions (pready 2, 0, 1, 3), two rounds through "
                     f"the same requests, bit for bit on {dev}")
    # µs per 8 B round trip between ranks 0 and 1, tracing off and on
    b8 = np.zeros(1, np.float64)
    rt = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        (trace.enable if mode == "on" else trace.disable)()
        w.barrier()
        if r in (0, 1):
            reps_ = 200
            t0 = time.perf_counter()
            for _ in range(reps_):
                if r == 0:
                    w.send(b8, 1, tag=5)
                    w.recv(1, tag=5)
                else:
                    w.recv(0, tag=5)
                    w.send(b8, 0, tag=5)
            rt[mode].append((time.perf_counter() - t0) / reps_ * 1e6)
    trace.disable()
    polls = w.allgather(polls)[1]            # rank 1 polled
    if r == 0:
        lines.append(f"8 B round trip (ranks 0 and 1) host us, tracing off "
                     f"then on, in turns (off on on off): "
                     + ", ".join(f"{u:.1f}" for u in (
                         rt["off"][0], *rt["on"], rt["off"][1]))
                     + f"; rank 1 polled parrived in {polls} rounds over "
                     f"the 2 partitioned rounds")
    w.barrier()
    MPI.Finalize()
    if r == 0:
        with open(report, "w") as f:
            json.dump(lines, f)
    print(f"OK observe rank={r}/{n}", flush=True)
    return 0


def phase_observe_world(w, smi: str) -> float:
    """Phase 13, first half: tracing, monitoring and SPC on the 8-rank
    world, the unsigned reductions and the pessimist engine on the card.
    Returns the seconds it took."""
    t0 = time.perf_counter()
    dev = w.device
    for line in _obs_tracing(w, dev, LOCAL_ELEMS):
        phase("observe", f"{line} | {smi}")
    phase("observe", _obs_unsigned(w, dev))
    phase("observe", _obs_vprotocol(w, dev, 1 << 18))
    return time.perf_counter() - t0


def phase_observe_job(smi: str, world_s: float) -> None:
    """Phase 13, second half: the traced per-rank job."""
    t0 = time.perf_counter()
    for line in _run_job("--observe-rank", [("mpi_base_trace_enable", 1)]):
        phase("observe", f"{line} | {smi}")
    phase("observe", f"phase 13 took {world_s + time.perf_counter() - t0:.1f}"
          f" s | {smi}")


# -- phase 14 ----------------------------------------------------------
RES_SEED = 1400
RES_VICTIM = 5                 # the per-rank job's killed rank
RES_HB_TIMEOUT = 0.8           # p34's heartbeat settings
RES_ENV = (("mpi_base_telemetry", 1), ("mpi_base_ft_hb_period", 0.1),
           ("mpi_base_ft_hb_timeout", RES_HB_TIMEOUT),
           ("mpi_base_ft_hb_miss", 3), ("mpi_base_ft_inject", 1),
           ("mpi_base_shm_zerocopy", 1))
# armed after the healthy allreduces are timed: the victim exits at the
# 2nd allreduce after that
RES_KILL = f"rank={RES_VICTIM},point=coll.allreduce,hit=2"


def _res_std(t, dev, host) -> list:
    """The Standard collectives on ``t`` (stacked ``host`` rows on the
    card), each against numpy on the host copy."""
    n = t.size
    x = t.put(host)
    _close(t.allreduce(x, MPI.SUM).cpu().numpy(),
           np.broadcast_to(host.sum(0), host.shape), 1e-5, 1e-5,
           "telemetry allreduce")
    check(np.array_equal(t.bcast(x, root=3).cpu().numpy(),
                         np.broadcast_to(host[3], host.shape)),
          "telemetry bcast")
    g = t.allgather(x[:, :1024]).cpu().numpy()
    check(all(np.array_equal(g[i], host[:, :1024]) for i in range(n)),
          "telemetry allgather")
    y = x.view(n, n, -1)
    yh = host.reshape(n, n, -1)
    check(np.array_equal(t.alltoall(y).cpu().numpy(),
                         np.swapaxes(yh, 0, 1)), "telemetry alltoall")
    _close(t.reduce_scatter_block(y, MPI.SUM).cpu().numpy(), yh.sum(0),
           1e-5, 1e-5, "telemetry reduce_scatter_block")
    t.barrier()
    return ["allreduce", "bcast", "allgather", "alltoall",
            "reduce_scatter_block", "barrier"]


def _res_telemetry(w, dev, smi) -> list:
    """Phase 14(a), telemetry: histograms on a dup built with the plane
    on, retirement at free, the Prometheus text and the dump, and the
    8 B allreduce's cost with the plane off and on."""
    import tempfile

    from ompi_tpu_torch import telemetry
    from ompi_tpu_torch.telemetry import prom
    from ompi_tpu_torch.trace import attribution
    n, lines = w.size, []
    rng = np.random.default_rng(RES_SEED)
    host = rng.standard_normal((n, LOCAL_ELEMS), dtype=np.float32)
    telemetry.enable()
    t = w.dup()
    check(t.c_coll and all(isinstance(m, telemetry._HistSlot)
                           for m in t.c_coll.values()),
          "telemetry: the dup's vtable is not wrapped")
    funcs = _res_std(t, dev, host)
    x = t.put(host)
    ev_ms = device_ms(lambda: t.allreduce(x, MPI.SUM), iters=10, warmup=2)
    sclass = telemetry.SIZE_CLASS_NAMES[telemetry.size_class(
        x.numel() * x.element_size())]
    huge = telemetry.get_hist(
        f"tele_coll_allreduce_c{telemetry._cid_token(t.cid)}_{sclass}")
    snap = huge.snapshot()
    counted = {f: sum(h.merged()["count"] for h in telemetry.histograms()
                      if h.comm == str(t.cid)
                      and h.labels.get("func") == f) for f in funcs}
    check(all(c >= 1 for c in counted.values()) and snap["count"] >= 13,
          f"telemetry counts {counted}, allreduce {sclass} "
          f"{snap['count']}")
    lines.append(
        f"telemetry on: a dup built with the plane on wraps its "
        f"{len(t.c_coll)} slots; the Standard collectives at "
        f"{LOCAL_ELEMS * 4 >> 20} MB per rank = numpy; calls counted per "
        f"func {counted}; {LOCAL_ELEMS * 4 >> 20} MB allreduce histogram "
        f"p50 {snap['p50'] / 1e3:.3f} ms p99 {snap['p99'] / 1e3:.3f} ms "
        f"(host clock of the app-visible call, {snap['count']} calls) "
        f"beside its CUDA-event time {ev_ms:.3f} ms (median of 10)")
    attribution.late_arrival([
        {"kind": "span", "name": "coll_allreduce", "cid": t.cid, "seq": 1,
         "rank": q, "ts": 1.0 + (0.2 if q == 3 else 0.0), "dur": 1e-3}
        for q in range(n)])
    mine = [p for p in pvar.pvar_names()
            if p == f"trace_skew_c{t.cid}" or f"_c{t.cid}_" in p]
    check(f"trace_skew_c{t.cid}" in mine and len(mine) > 1,
          f"per-comm pvars before free: {mine}")
    text = prom.render(rank=0)
    check("# TYPE ompi_tpu_tele_coll_allreduce histogram" in text,
          "prom text has no allreduce family")
    with tempfile.TemporaryDirectory() as tmp:
        path = telemetry.dump(os.path.join(tmp, "telemetry_0.json"), rank=0)
        with open(path) as f:
            dumped = json.load(f)
    check(dumped["telemetry"] == 1 and any(
        h["name"] == huge.name for h in dumped["hists"]), "telemetry dump")
    t.free()
    left = [p for p in mine if p in set(pvar.pvar_names())]
    check(left == [] and not [h for h in telemetry.histograms()
                              if h.comm == str(t.cid)],
          f"per-comm pvars after free: {left}")
    lines.append(
        f"free() retired the dup's {len(mine)} per-comm pvars "
        f"(trace_skew_c{t.cid} and its histograms); prom text "
        f"{len(text.splitlines())} lines; the dump holds "
        f"{len(dumped['hists'])} histograms")
    # 8 B allreduce: the plane off (a comm built with it off: no shim)
    # and on, in turns
    telemetry.disable()
    off = w.dup()
    telemetry.enable()
    on = w.dup()
    us = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        us[mode].append(_obs_8b_us(off if mode == "off" else on))
    telemetry.disable()
    gated = _obs_8b_us(on)           # wrapped, plane off: one read
    on.free()
    off.free()
    lines.append(
        f"8 B allreduce host us, telemetry off then on, in turns (off on "
        f"on off): {us['off'][0]:.2f}, {us['on'][0]:.2f}, "
        f"{us['on'][1]:.2f}, {us['off'][1]:.2f}; on costs "
        f"{(statistics.mean(us['on']) / statistics.mean(us['off']) - 1):.1%}"
        f"; a wrapped comm with the plane turned off {gated:.2f}")
    return lines


def _res_ulfm(w, dev, smi) -> list:
    """Phase 14(a), ULFM: fail world rank 3, then revoke, agree and
    shrink; the shrunk comm's 32 MB allreduce and a DDP step on it."""
    from ompi_tpu_torch.runtime import ft
    n, lines = w.size, []
    check(ft.Registry().probe_devices(w.devices) == [],
          "probe_devices on the 8 cuda:0 handles")
    rng = np.random.default_rng(RES_SEED + 1)
    host = rng.standard_normal((n, LOCAL_ELEMS), dtype=np.float32)
    f = w.dup()
    f.set_errhandler(MPI.ERRORS_RETURN)
    x = f.put(host)
    before = device_ms(lambda: f.allreduce(x, MPI.SUM), iters=10, warmup=2)
    # the DDP synchronizer is built while all 8 ranks live
    cfg = dataclasses.replace(CONFIG, dtype=torch.float32)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    specs = tree_map(lambda _: P(), params)
    sync = T.BucketedGradSync(f, Mesh((n,), ("dp",), dev).shard(params,
                                                              specs))
    ft.fail_rank(f.group.world_ranks[3], "phase 14 drill")
    raised = []
    for name, fn in (("allreduce", lambda: f.allreduce(x, MPI.SUM)),
                     ("send", lambda: f.send(x[0], src=0, dest=3)),
                     ("recv", lambda: f.recv(source=3, dst=0))):
        try:
            fn()
        except MPI.MPIError as e:
            raised.append((name, e.error_class))
    check(raised == [("allreduce", MPI.ERR_PROC_FAILED),
                     ("send", MPI.ERR_PROC_FAILED),
                     ("recv", MPI.ERR_PROC_FAILED)], f"raised {raised}")
    t0 = time.perf_counter()
    f.revoke()
    try:
        f.agree([0b11] * n)
        check(False, "agree over an unacknowledged failure returned")
    except MPI.MPIError as e:
        check(e.error_class == MPI.ERR_PROC_FAILED and "[3]" in str(e)
              and e.agreed_value == 0b11, f"agree: {e}")
    s = f.shrink()
    rs_ms = (time.perf_counter() - t0) * 1e3
    check(s.size == n - 1 and 3 not in s.group.world_ranks
          and s.device == dev, f"shrunk comm {s}")
    xs = f.survivor_rows(x, s)
    check(xs.device == dev, "survivor rows left the card")
    keep = [r for r in range(n) if r != 3]
    _close(s.allreduce(xs, MPI.SUM).cpu().numpy(),
           np.broadcast_to(host[keep].sum(0), (n - 1, LOCAL_ELEMS)),
           1e-5, 1e-5, "shrunk allreduce")
    after = device_ms(lambda: s.allreduce(xs, MPI.SUM), iters=10, warmup=2)
    lines.append(
        f"fail_rank(3): allreduce, send and recv naming rank 3 raise "
        f"ERR_PROC_FAILED; revoke, agree (reports [3], agreed "
        f"{0b11:#b}) and shrink to {s.size} ranks took {rs_ms:.2f} ms "
        f"(host clock); {LOCAL_ELEMS * 4 >> 20} MB allreduce on the "
        f"survivors' rows of the stacked {dev} tensor = numpy of the 7 "
        f"rows, {after:.3f} ms against {before:.3f} ms on 8 ranks (CUDA "
        f"events, median of 10); probe_devices on the 8 handles: []")
    lines.append(_res_ddp(sync, s, cfg, params, specs, dev))
    return lines


def _res_ddp(sync, s, cfg, params, specs, dev) -> str:
    """``sync`` (a BucketedGradSync built on the 8 ranks) shrunk onto
    ``s``, one DDP step there against the in-graph dp pmean on the same
    7 ranks."""
    n = s.size
    mesh = Mesh((n,), ("dp",), dev)
    start = mesh.shard(params, specs)
    tok = torch.from_numpy(np.random.default_rng(RES_SEED + 2).integers(
        0, cfg.vocab, (2 * n, cfg.seq + 1)))
    batch = mesh.shard((tok[:, :-1], tok[:, 1:]), (P("dp"), P("dp")))
    dpc = InGraphComm("dp", n, mesh)
    sync.shrink(s)
    check(sync.n == n and sync.comm is s, "BucketedGradSync.shrink")
    pa, la = T.sgd_train_step(start, batch, cfg, 1e-2, dpc, grad_sync=sync)
    pc, lc = T.sgd_train_step(start, batch, cfg, 1e-2, dpc)
    div = mesh.divergence(pa, specs)
    check(np.isfinite(float(la[0])) and div <= 1e-6,
          f"DDP on the shrunk comm: loss {float(la[0])}, divergence {div}")
    _ddp_losses_close([float(la[0])], [float(lc[0])], "shrunk DDP step")
    worst = max((a - b).abs().max().item()
                for a, b in zip(tree_leaves(pa), tree_leaves(pc)))
    check(all(bool(torch.allclose(a, b, rtol=2e-4, atol=2e-6))
              for a, b in zip(tree_leaves(pa), tree_leaves(pc))),
          f"shrunk DDP params differ from the pmean step by {worst:.3g}")
    return (f"BucketedGradSync built on 8 ranks, shrunk onto {n}: one "
            f"full-width DDP step, loss {float(la[0]):.6f} (pmean step "
            f"{float(lc[0]):.6f}), replicated-leaf divergence {div:.3g}, "
            f"params within rtol 2e-4 atol 2e-6 of the pmean step (max "
            f"abs diff {worst:.3g})")


def phase_resilience_world(w, smi: str) -> float:
    """Phase 14(a) on the live 8-rank world, just before Finalize (it
    leaves world rank 3 failed). Returns the seconds it took."""
    t0 = time.perf_counter()
    dev = w.device
    for line in _res_telemetry(w, dev, smi) + _res_ulfm(w, dev, smi):
        phase("resilience", f"{line} | {smi}")
    return time.perf_counter() - t0


def _resilience_rank(report: str) -> int:
    """The rank program of phase 14(b) (mpirun --per-rank
    --enable-recovery, telemetry and heartbeats on, rank 5 killed at its
    2nd allreduce); each survivor writes its flight record, rank 0 its
    lines to ``report``."""
    from ompi_tpu_torch import telemetry
    from ompi_tpu_torch.accelerator import job_tag
    from ompi_tpu_torch.ft import inject
    from ompi_tpu_torch.runtime import ft
    from ompi_tpu_torch.telemetry import flightrec
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = w.device
    out_dir = os.path.dirname(report)
    check(telemetry.active and w.router.detector is not None,
          f"rank {r}: telemetry or the detector is off")
    w.set_errhandler(MPI.ERRORS_RETURN)
    w.barrier()
    # a 1 MiB host ring through the zero-copy pools: every rank, the
    # victim too, maps its /dev/shm pools before the kill
    h = np.full(1 << 18, float(r), np.float32)
    w.send(h, (r + 1) % n, tag=3)
    got, _ = w.recv((r - 1) % n, tag=3)
    check(np.array_equal(got, np.full(1 << 18, float((r - 1) % n),
                                      np.float32)), f"rank {r}: host ring")
    base = (torch.arange(LOCAL_ELEMS, device=dev) % 1024).float()
    x = base + r
    full = base * n + n * (n - 1) / 2

    def timed(comm, want) -> float:
        """Median host ms of 5 synchronised 32 MB allreduces on
        ``comm`` (after one untimed), each equal to ``want``."""
        times = []
        for i in range(6):
            comm.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = comm.allreduce(x, MPI.SUM)
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
            check(y.device == dev and torch.equal(y, want),
                  f"rank {r}: allreduce on {comm.name}")
        return statistics.median(times)

    before_ms = timed(w, full)
    var.var_set("mpi_base_ft_inject_kill", RES_KILL)
    inject.refresh()
    check(torch.equal(w.allreduce(x, MPI.SUM), full),   # point hit 1
          f"rank {r}: healthy allreduce")
    t_in = time.perf_counter()
    try:
        w.allreduce(x, MPI.SUM)                      # the victim dies here
        check(False, f"rank {r}: an allreduce over a dead rank returned")
    except MPI.MPIError as e:
        # a survivor blocked on a live peer that bailed out is released
        # by the revoke that any first detector floods
        check(e.error_class in (MPI.ERR_PROC_FAILED, MPI.ERR_REVOKED),
              f"rank {r}: {e}")
    t_rev = time.perf_counter()
    err_ms = (t_rev - t_in) * 1e3
    w.revoke()
    deadline = time.monotonic() + 30
    while w.get_failed() != [RES_VICTIM]:
        check(time.monotonic() < deadline, f"rank {r}: {w.get_failed()}")
        time.sleep(0.01)
    check(w.agree(1) == 1, f"rank {r}: agree")
    s = w.shrink()
    rs_ms = (time.perf_counter() - t_rev) * 1e3
    sr, sn = s.rank(), s.size
    check(sn == n - 1 and sr == (r if r < RES_VICTIM else r - 1),
          f"rank {r}: shrunk to {sn}, rank {sr}")
    lat = pvar.pvar_read("ft_detect_latency_us")
    after_ms = timed(s, base * sn + sum(q for q in range(n)
                                        if q != RES_VICTIM))
    # a devxfer ring of 32 MB CUDA tensors among the survivors
    pulls = w.router.xfer.stats["received"]
    msg = base * (sr + 1)
    s.send(msg, (sr + 1) % sn, tag=4)
    got, _ = s.recv((sr - 1) % sn, tag=4)
    check(got.device == dev and torch.equal(got, base * ((sr - 1) % sn + 1)),
          f"rank {r}: devxfer ring")
    xfer = w.router.xfer.stats["received"] - pulls
    failed = sorted(ft.failed_ranks())
    rows = s.allgather((lat, rs_ms, before_ms, after_ms, failed, xfer,
                        err_ms))
    s.barrier()                       # every flight record is written
    frecs = sorted(f for f in os.listdir(out_dir)
                   if f.startswith("flightrec_") and f.endswith(".json"))
    if r == 0:
        pays = []
        for name in frecs:
            with open(os.path.join(out_dir, name)) as fh:
                pays.append(json.load(fh))
        rep = flightrec.merge(pays)
        ranks = sorted({p["rank"] for p in pays})
        check(rep["critical_rank"] == RES_VICTIM
              and rep.get("critical_absent") is True
              and ranks == [q for q in range(n) if q != RES_VICTIM],
              f"flight records: ranks {ranks}, report {rep}")
        check(all(row[4] == [RES_VICTIM] for row in rows),
              f"a survivor was declared: {[row[4] for row in rows]}")
        # detection: every survivor's failed allreduce raised within 2x
        # the heartbeat timeout, and so did the ft_detect_latency_us of
        # the victim's ring successor, the one rank that heard its beats
        # (the others count from their detector's start, as the
        # reference's pvar does)
        lats = [row[0] for row in rows]
        errs = [row[6] for row in rows]
        succ = RES_VICTIM                # its shrunk rank is the victim's
        check(max(errs) < 2 * RES_HB_TIMEOUT * 1e3
              and lats[succ] < 2 * RES_HB_TIMEOUT * 1e6,
              f"detection: errors after {errs} ms, latencies {lats} us")
        lines = [
            f"8 rank processes on {dev}, telemetry and heartbeats on "
            f"(period 0.1 s, timeout {RES_HB_TIMEOUT} s, miss 3): rank "
            f"{RES_VICTIM} exited at its 2nd allreduce after the kill "
            f"spec was armed; the 7 survivors "
            f"saw ERR_PROC_FAILED or ERR_REVOKED, revoked, agreed and "
            f"shrank; failed set {rows[0][4]} on every survivor (none "
            f"declared); detection latency us per survivor {lats} (limit "
            f"{2 * RES_HB_TIMEOUT * 1e6:.0f}; the silence since the "
            f"victim was last known alive, less one period: its ring "
            f"successor heard its beats, the others count from their "
            f"detector's start); the failed allreduce raised after ms "
            f"{[round(row[6], 1) for row in rows]}",
            f"revoke -> shrink ms per survivor "
            f"{[round(row[1], 2) for row in rows]}; "
            f"{LOCAL_ELEMS * 4 >> 20} MB CUDA allreduce ms on rank 0 "
            f"(host clock with the fences, median of 5): {rows[0][2]:.3f} "
            f"on 8 ranks and {rows[0][3]:.3f} on the 7 survivors, = exact "
            f"sums; devxfer ring of "
            f"{LOCAL_ELEMS * 4 >> 20} MB CUDA tensors among the "
            f"survivors pulled {sum(row[5] for row in rows)} slots",
            f"flight records {frecs}; flightrec.merge: critical rank "
            f"{rep['critical_rank']} (absent: "
            f"{rep.get('critical_absent')}), accusations "
            f"{rep['accusations']}; job tag {job_tag()}"]
        with open(report, "w") as fh:
            json.dump({"lines": lines, "tag": job_tag()}, fh)
    s.free()
    w.free()
    MPI.Finalize()
    print(f"OK resilience rank={r}/{n}", flush=True)
    return 0


def phase_resilience_job(smi: str, world_s: float) -> None:
    """Phase 14(b): the per-rank ULFM drill, 8 rank processes on cuda:0,
    with the launcher in recovery mode (the victim's 137 is the job's
    rc; the 7 survivors must print OK)."""
    import glob
    import tempfile
    from ompi_tpu_torch.accelerator import SHM_DIR
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "rank0.json")
        cmd = [sys.executable,
               os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py"),
               "--per-rank", "-n", str(PR_RANKS), "--timeout",
               str(PR_TIMEOUT), "--enable-recovery",
               "--mca", "mpi_base_telemetry_flightrec_dir", tmp]
        for k, v in RES_ENV:
            cmd += ["--mca", k, str(v)]
        cmd += [os.path.abspath(__file__), "--resilience-rank", report]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=PR_TIMEOUT + 60, cwd=root)
        oks = res.stdout.count("OK resilience")
        if res.returncode != 137 or oks != PR_RANKS - 1:
            sys.stderr.write(res.stderr[-6000:])
            check(False, f"resilience job rc={res.returncode} (want 137), "
                  f"{oks} of {PR_RANKS - 1} survivors OK:\n"
                  f"{res.stdout[-3000:]}")
        cuda_err = [ln for ln in res.stderr.splitlines()
                    if "CUDA error" in ln or "cudaError" in ln]
        check(not cuda_err, f"CUDA errors in the survivors' stderr: "
              f"{cuda_err[:5]}")
        with open(report) as f:
            rep = json.load(f)
    left = glob.glob(os.path.join(SHM_DIR, f"otpt*_{rep['tag']}_*"))
    check(rep["tag"] and not left, f"shared segments left: {left}")
    for line in rep["lines"]:
        phase("resilience", f"{line} | {smi}")
    phase("resilience", f"no otpt*_{rep['tag']}_* file left under "
          f"{SHM_DIR}; no CUDA error in any survivor's stderr; phase 14 "
          f"took {world_s + time.perf_counter() - t0:.1f} s | {smi}")


# -- phase 15 ----------------------------------------------------------
SES_SEED = 1500
SES_CHILD = 4                  # ranks of the spawned child world
SES_JOB_TIMEOUT = 60           # seconds each per-rank job may take
SES_JOB_PHASE_S = 90           # the per-rank part must end within this
SES_SEG = 1 << 18              # adapt's segment: 1 MB of fp32 per rank
SES_DIRECT = ("allreduce", "bcast", "reduce", "allgather")


def _dtoh_events(fn) -> int:
    """Device-to-host copies inside ``fn()``: the ``Memcpy DtoH`` events
    ``torch.profiler`` records from the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "DtoH" in e.key)


def _dup_with(w, **vals):
    """A dup of ``w`` selected while the MCA vars ``vals`` hold; the
    global values come back after."""
    saved = {k: var.var_get(k) for k in vals}
    for k, v in vals.items():
        var.var_set(k, v)
    try:
        return w.dup()
    finally:
        for k, v in saved.items():
            var.var_set(k, v)


def _composed(w) -> list:
    """(name, comm) of phase 15's composition dups: han with low groups
    of 4, xhc with levels 2,2 and xhc on the host ladder."""
    xa = _dup_with(w, coll_xhc_priority=80)
    return [("han split 4", _dup_with(w, coll_han_priority=80,
                                      coll_han_split=4)),
            ("xhc 2,2", _dup_with(w, coll_xhc_priority=80,
                                  coll_xhc_levels="2,2")),
            (f"xhc auto ({xa.c_coll['allreduce'].level_basis})", xa)]


def _fresh_check(report: str) -> int:
    """Phase 15's checks that need a process of their own
    (``--fresh-check``, started by ``phase_sessions_world``). The DtoH
    counts: in the script's own process torch.profiler stops reporting
    memcpy records once phases 3 and 4 have run, so a zero there would
    prove nothing. An 8-row world on cuda:0 runs the intercomm's four
    collectives with a spawned 4-row child and han's and xhc's at 32 MB
    fp32 per rank, each once to warm and once under the profiler; a 4 KB
    ``.cpu()`` is the positive control. Then the 8 B allreduce on the
    world and on a session comm with no override, in turns."""
    from ompi_tpu_torch.runtime import session as S
    dev = torch.device("cuda", 0)
    MPI.Init(devices=[dev] * N_RANKS)
    w = MPI.get_comm_world()
    n, m = w.size, SES_CHILD
    g = torch.Generator(device=dev).manual_seed(SES_SEED)
    x = torch.randn((n, LOCAL_ELEMS), device=dev, generator=g)
    cx = torch.randn((m, LOCAL_ELEMS), device=dev, generator=g)
    inter = MPI.Comm_spawn(None, m, w)
    q = LOCAL_ELEMS // m
    la = x.view(n, m, q)
    rb = cx.view(m, n, LOCAL_ELEMS // n)[:, :, :q].contiguous()
    calls = {"intercomm bcast": lambda: inter.bcast(x[2], root=2),
             "intercomm allreduce": lambda: inter.allreduce(x, cx, MPI.SUM),
             "intercomm allgather": lambda: inter.allgather(x, cx),
             "intercomm alltoall": lambda: inter.alltoall(la, rb)}
    for name, c in _composed(w):
        calls[f"{name} allreduce"] = (
            lambda c=c: c.allreduce(x, MPI.SUM))
        calls[f"{name} bcast"] = lambda c=c: c.bcast(x, root=5)
        calls[f"{name} reduce"] = lambda c=c: c.reduce(x, MPI.SUM, root=6)
        if name.startswith("han"):
            calls[f"{name} allgather"] = lambda c=c: c.allgather(x)
    counts = {}
    for name, fn in calls.items():
        fn()
        counts[name] = _dtoh_events(fn)
        torch.cuda.empty_cache()
    t = torch.ones(1024, device=dev)
    rep = {"counts": counts, "control": _dtoh_events(lambda: t.cpu())}
    s0 = S.Session(devices=[dev] * n)
    c0 = s0.comm_create_from_group(s0.group_from_pset("mpi://WORLD"))
    small_w = w.alloc((2,), dtype=torch.float32, fill=1.0)
    small_s = c0.alloc((2,), dtype=torch.float32, fill=1.0)
    rep["us"] = [_us_per_call(lambda: w.allreduce(small_w, MPI.SUM)),
                 _us_per_call(lambda: c0.allreduce(small_s, MPI.SUM)),
                 _us_per_call(lambda: c0.allreduce(small_s, MPI.SUM)),
                 _us_per_call(lambda: w.allreduce(small_w, MPI.SUM))]
    s0.finalize()
    with open(report, "w") as fh:
        json.dump(rep, fh)
    MPI.Finalize()
    return 0


def _ses_fresh(smi: str) -> list:
    """Runs ``_fresh_check`` in a fresh process and holds its counts: 0 in
    every call, at least 1 in the control."""
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "dtoh.json")
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--fresh-check", report], capture_output=True,
                             text=True, timeout=180, cwd=root)
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-6000:])
            check(False, f"the fresh-process check exited "
                  f"{res.returncode}")
        with open(report) as f:
            rep = json.load(f)
    check(rep["control"] >= 1, f"the profiler saw {rep['control']} DtoH "
          f"events in a .cpu() copy: it cannot vouch for zero elsewhere")
    bad = {k: v for k, v in rep["counts"].items() if v}
    check(not bad, f"Memcpy DtoH events inside {bad}")
    us = rep["us"]
    return [f"0 Memcpy DtoH events (torch.profiler, a fresh process) in "
            f"each of {len(rep['counts'])} calls at "
            f"{LOCAL_ELEMS * 4 >> 20} MB per rank: "
            f"{', '.join(rep['counts'])}; the control's .cpu() copy "
            f"showed {rep['control']}",
            f"the same fresh process, 8 B allreduce host us/call (2000 "
            f"calls after 200, in turns world, session, session, world; no "
            f"override): {us[0]:.2f}, {us[1]:.2f}, {us[2]:.2f}, "
            f"{us[3]:.2f}; the scope wrapper costs "
            f"{(us[1] + us[2] - us[0] - us[3]) / 2:.2f} us/call"]


def _direct_scope():
    """A var scope that forces coll/torch's direct lowering: the
    comparison baseline, with the global store untouched."""
    sc = var.VarScope()
    for func in SES_DIRECT:
        sc.set(f"coll_torch_{func}_algorithm", "direct")
    return sc


def _us_per_call(fn, calls: int = 2000, warmup: int = 200) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def _ses_sessions(w, x, xh, smi: str) -> list:
    """15(a): two sessions with their own algorithm in their own scope."""
    from ompi_tpu_torch.runtime import ft
    from ompi_tpu_torch.runtime import session as S
    dev, n = w.device, w.size
    alg = "coll_torch_allreduce_algorithm"
    want = np.broadcast_to(xh.sum(0), xh.shape)
    r0 = S.instance_refcount()
    world_alg = w._coll("allreduce").selected("allreduce", x, MPI.SUM)
    world_var = var.var_get(alg)
    sessions = [(S.Session(devices=[dev] * n), "ring"),
                (S.Session(devices=[dev] * n), "recursive_doubling")]
    check(S.instance_refcount() == r0 + 2, "session refcount")
    comms = []
    for s, name in sessions:
        s.var_set(alg, name)
        c = s.comm_create_from_group(s.group_from_pset("mpi://WORLD"))
        check(isinstance(c, S.SessionCommunicator) and c.cid == 0
              and c.device == dev, f"session comm {c!r}")
        # the deferred round first, on a fresh comm: the schedule it
        # builds is the session's algorithm
        req = c.iallreduce(x, MPI.SUM)
        req.wait()
        y = req.get()
        check(y.device == dev, "session iallreduce device")
        _close(y.cpu().numpy(), want, 1e-5, 1e-5, f"{name} iallreduce")
        built = [k for k in c.c_coll["allreduce"].device._cache
                 if k[0] == "allreduce"]
        check(built and all(k[1] == name for k in built),
              f"{name} session's deferred round built {built}")
        y = c.allreduce(x, MPI.SUM)
        _close(y.cpu().numpy(), want, 1e-5, 1e-5, f"{name} allreduce")
        with var.scope(s.scope):
            sel = c._coll("allreduce").selected("allreduce", x, MPI.SUM)
        check(sel == name, f"session selected {sel}, wanted {name}")
        d = c.dup()
        check(isinstance(d, S.SessionCommunicator) and d.cid == 1,
              f"a session dup drew cid {d.cid}")
        comms.append((c, d))
    check(var.var_get(alg) == world_var and w._coll("allreduce").selected(
        "allreduce", x, MPI.SUM) == world_alg, "the world's pick moved")
    (c1, _), (c2, _) = comms
    s1 = sessions[0][0]
    # a failure injected in session 1 stays there
    c1.set_errhandler(MPI.ERRORS_RETURN)
    s1.ft_registry.fail_rank(0, "injected in session 1")
    try:
        c1.allreduce(x, MPI.SUM)
        check(False, "session 1's allreduce over its failed rank returned")
    except MPI.MPIError as e:
        check(e.error_class == MPI.ERR_PROC_FAILED, f"session 1: {e}")
    check(not ft.is_failed(0), "the world registry saw session 1's failure")
    _close(c2.allreduce(x, MPI.SUM).cpu().numpy(), want, 1e-5, 1e-5,
           "session 2 after session 1's failure")
    _close(w.allreduce(x, MPI.SUM).cpu().numpy(), want, 1e-5, 1e-5,
           "world after session 1's failure")
    # the wrapper's cost: a session with no override runs the world's
    # algorithm, so only the scope differs
    s0 = S.Session(devices=[dev] * n)
    c0 = s0.comm_create_from_group(s0.group_from_pset("mpi://WORLD"))
    small_w = w.alloc((2,), dtype=torch.float32, fill=1.0)
    small_s = c0.alloc((2,), dtype=torch.float32, fill=1.0)
    with var.scope(s0.scope):
        check(c0._coll("allreduce").selected("allreduce", small_s, MPI.SUM)
              == w._coll("allreduce").selected("allreduce", small_w,
                                               MPI.SUM),
              "the timed session comm runs another algorithm")
    us = [_us_per_call(lambda: w.allreduce(small_w, MPI.SUM)),
          _us_per_call(lambda: c0.allreduce(small_s, MPI.SUM)),
          _us_per_call(lambda: c0.allreduce(small_s, MPI.SUM)),
          _us_per_call(lambda: w.allreduce(small_w, MPI.SUM))]
    s0.finalize()
    for s, _ in sessions:
        s.finalize()
    check(all(c._freed and d._freed for c, d in comms),
          "finalize left a session comm alive")
    check(S.instance_refcount() == r0, "the refcount did not fall back")
    return [
        f"two Session(devices=[{dev}] * {n}): coll_torch_allreduce_algorithm "
        f"ring and recursive_doubling in their scopes, the world's "
        f"'{world_var}' (picks {world_alg}) unchanged; each session's "
        f"deferred iallreduce built only its algorithm, its allreduce "
        f"= numpy (rtol 1e-5, atol 1e-5) and selected() names it; CIDs "
        f"0, 1 in each session's space; a failure injected in session "
        f"1's registry raised there alone (session 2 and the world = "
        f"numpy); finalize freed all 4 comms, refcount back to {r0}",
        f"8 B allreduce host us/call (2000 calls after 200, in turns world, "
        f"session, session, world; the session has no override, so both "
        f"run the world's algorithm): {us[0]:.2f}, {us[1]:.2f}, "
        f"{us[2]:.2f}, {us[3]:.2f}; the scope wrapper costs "
        f"{(us[1] + us[2] - us[0] - us[3]) / 2:.2f} us/call"]


def _ses_dpm(w, x, xh, smi: str) -> list:
    """15(b): spawn, the intercomm collectives and the rendezvous."""
    from ompi_tpu_torch.core import dpm
    dev, n, m = w.device, w.size, SES_CHILD
    ran = []

    def child_main(child):
        y = child.allreduce(child.alloc((4,), fill=2.0), MPI.SUM)
        ran.append((child.size, y.device, y.cpu().tolist()))

    inter = MPI.Comm_spawn(child_main, m, w)
    child = inter.remote_comm
    check(ran == [(m, dev, [[2.0 * m] * 4] * m)]
          and child.devices == (dev,) * m,
          f"spawned child: {ran}, {child.devices}")
    check(MPI.Comm_get_parent(child).remote_size == n
          and MPI.Comm_get_parent(w) is None, "Comm_get_parent")
    g = torch.Generator(device=dev).manual_seed(SES_SEED + 1)
    cx = torch.randn((m, LOCAL_ELEMS), device=dev, generator=g)
    cxh = cx.cpu().numpy()
    q = LOCAL_ELEMS // m
    la = x.view(n, m, q)
    rb = cx.view(m, n, LOCAL_ELEMS // n)[:, :, :q].contiguous()
    # the intercomm collectives, each held against its expected value and
    # profiled for device-to-host copies
    calls = {
        "bcast": lambda: inter.bcast(x[2], root=2),
        "allreduce": lambda: inter.allreduce(x, cx, MPI.SUM),
        "allgather": lambda: inter.allgather(x, cx),
        "alltoall": lambda: inter.alltoall(la, rb),
    }
    out = calls["bcast"]()
    check(out.device == dev and out.shape == (m, LOCAL_ELEMS)
          and torch.equal(out, x[2].expand(m, -1)), "intercomm bcast")
    lo, ro = calls["allreduce"]()
    check(lo.device == ro.device == dev, "intercomm allreduce device")
    _close(lo.cpu().numpy(), np.broadcast_to(cxh.sum(0), (n, LOCAL_ELEMS)),
           1e-5, 1e-5, "intercomm allreduce local side")
    _close(ro.cpu().numpy(), np.broadcast_to(xh.sum(0), (m, LOCAL_ELEMS)),
           1e-5, 1e-5, "intercomm allreduce remote side")
    del lo, ro
    lo, ro = calls["allgather"]()
    check(lo.device == ro.device == dev and lo.shape == (n, m, LOCAL_ELEMS)
          and ro.shape == (m, n, LOCAL_ELEMS)
          and all(torch.equal(lo[i], cx) for i in range(n))
          and all(torch.equal(ro[j], x) for j in range(m)),
          "intercomm allgather")
    del lo, ro
    lo, ro = calls["alltoall"]()
    check(lo.device == ro.device == dev
          and torch.equal(lo, rb.transpose(0, 1))
          and torch.equal(ro, la.transpose(0, 1)), "intercomm alltoall")
    del lo, ro
    merged = inter.merge()
    check(merged.size == n + m and merged.devices == (dev,) * (n + m),
          f"merge: {merged.size} rows on {set(merged.devices)}")
    allx = torch.cat([x, cx])
    _close(merged.allreduce(allx, MPI.SUM).cpu().numpy(),
           np.broadcast_to(np.concatenate([xh, cxh]).sum(0),
                           (n + m, LOCAL_ELEMS)),
           1e-5, 1e-5, "merged allreduce")
    del allx
    ms = device_ms(lambda: inter.allreduce(x, cx, MPI.SUM), iters=10,
                   warmup=2)
    moved = 2 * (n + m) * LOCAL_ELEMS * 4
    # the rendezvous between the world's halves, the names, join
    halves = w.split([0] * (n // 2) + [1] * (n - n // 2))
    a, b = halves[0], halves[-1]
    port = MPI.Open_port()
    MPI.Publish_name("sessions-phase", port)
    check(MPI.Lookup_name("sessions-phase") == port, "Lookup_name")
    areq = MPI.Comm_iaccept(port, a)
    check(not areq.test()[0], "iaccept completed alone")
    ib = MPI.Comm_connect(port, b)
    ia = areq.get()
    check(areq.test()[0] and ia.remote_comm is b and ib.remote_comm is a,
          "accept/connect pairing")
    la2 = a.stack([x[i, :8] for i in range(a.size)])
    rb2 = b.stack([x[i, :8] for i in range(a.size, n)])
    lo, ro = ia.allreduce(la2, rb2, MPI.MAX)
    check(torch.equal(lo[0], rb2.max(0).values)
          and torch.equal(ro[0], la2.max(0).values), "halves' MAX")
    MPI.Unpublish_name("sessions-phase")
    MPI.Close_port(port)
    j1 = MPI.Comm_join("phase-15", a)
    jb = MPI.Comm_join("phase-15", b)
    check(j1.test()[0] and j1.get().remote_comm is b and jb.remote_comm is a,
          "Comm_join")
    MPI.Comm_disconnect(child)
    check(MPI.Comm_get_parent(child) is None and child._freed,
          "Comm_disconnect")
    MPI.Comm_disconnect(inter)
    dpm._reset_for_tests()
    return [
        f"Comm_spawn(child_main, {m}, world): a {m}-row child on {dev} "
        f"(its allreduce ran there); the intercomm's bcast, allreduce, "
        f"allgather and alltoall between the {n} parent and {m} child "
        f"rows at {LOCAL_ELEMS * 4 >> 20} MB per rank = numpy (sums rtol "
        f"1e-5) or the inputs exactly, every output on {dev}; merge: "
        f"{n + m} rows on {dev}, allreduce = numpy",
        f"intercomm allreduce SUM: {ms:.3f} ms device (CUDA events, "
        f"median of 10): {_hbm(moved, ms)} for the least in+out traffic",
        "Open_port/Publish_name/Lookup_name, Comm_iaccept pending until "
        "Comm_connect, the halves' intercomm MAX exact, Comm_join and "
        "Comm_disconnect (get_parent None after)"]


def _cmp_direct(what, got, direct, wanth, sums: bool) -> None:
    """``got`` against coll/torch's direct lowering and numpy: float sums
    rtol 1e-5 (atol 1e-5 near zero), everything else bit for bit."""
    if sums:
        _close(got.cpu().numpy(), direct.cpu().numpy(), 1e-5, 1e-5,
               f"{what} vs direct")
        _close(got.cpu().numpy(), wanth, 1e-5, 1e-5, f"{what} vs numpy")
    else:
        check(_bits(got, direct), f"{what} vs direct (bit for bit)")
        check(np.array_equal(_host(got), wanth), f"{what} vs numpy")


def _ses_compose(w, x, xh, smi: str) -> list:
    """15(c): han, xhc and adapt on the card."""
    from ompi_tpu_torch.coll import adapt, han, xhc
    dev, n = w.device, w.size
    g = torch.Generator(device=dev).manual_seed(SES_SEED + 2)
    xi = torch.randint(-1000, 1000, (n, LOCAL_ELEMS), device=dev,
                       dtype=torch.int32, generator=g)
    xih = xi.cpu().numpy()
    direct = _direct_scope()

    def flat(fn):
        with var.scope(direct):
            return fn()

    d_sum = flat(lambda: w.allreduce(x, MPI.SUM))
    d_max = flat(lambda: w.allreduce(x, MPI.MAX))
    d_int = flat(lambda: w.allreduce(xi, MPI.SUM))
    d_ms = device_ms(lambda: flat(lambda: w.allreduce(x, MPI.SUM)),
                     iters=10, warmup=2)
    want_sum = np.broadcast_to(xh.sum(0), xh.shape)
    want_max = np.broadcast_to(xh.max(0), xh.shape)
    want_int = np.broadcast_to(xih.sum(0, dtype=np.int32), xih.shape)
    moved = 2 * n * LOCAL_ELEMS * 4
    lines = []

    comps = _composed(w)
    hc, xc, xa = (c for _, c in comps)
    check(hc._coll_winners["allreduce"] == "han", "han not selected")
    hm = hc.c_coll["allreduce"]
    check(isinstance(hm, han.HanModule), "han module")
    for c in (xc, xa):
        check(c._coll_winners["allreduce"] == "xhc"
              and isinstance(c.c_coll["allreduce"], xhc.XhcModule),
              "xhc not selected")
    for name, c in comps:
        c.allreduce(x, MPI.SUM)               # builds han's tiers
        _cmp_direct(f"{name} allreduce SUM", c.allreduce(x, MPI.SUM),
                    d_sum, want_sum, True)
        _cmp_direct(f"{name} allreduce MAX", c.allreduce(x, MPI.MAX),
                    d_max, want_max, False)
        _cmp_direct(f"{name} allreduce i32", c.allreduce(xi, MPI.SUM),
                    d_int, want_int, False)
        check(np.array_equal(_host(c.bcast(x, root=5)),
                             np.broadcast_to(xh[5], xh.shape)),
              f"{name} bcast")
        _close(_host(c.reduce(x, MPI.SUM, root=6))[6], xh.sum(0), 1e-5,
               1e-5, f"{name} reduce")
        c.barrier()
        if c is hc:
            ag = hc.allgather(x)
            check(ag.device == dev and ag.shape == (n, n, LOCAL_ELEMS)
                  and all(torch.equal(ag[i], x) for i in range(n)),
                  "han allgather")
            del ag
        ms = device_ms(lambda: c.allreduce(x, MPI.SUM), iters=10, warmup=2)
        mod = c.c_coll["allreduce"]
        shape = (f"low groups {mod.h.groups}" if c is hc
                 else f"levels {mod.levels}")
        lines.append(
            f"{name}: {shape}; "
            f"allreduce SUM/MAX/i32, bcast, reduce"
            f"{', allgather' if c is hc else ''} and barrier = numpy, "
            f"MAX and i32 = direct bit for bit, SUM = direct rtol 1e-5; "
            f"allreduce SUM "
            f"{ms:.3f} ms device against direct {d_ms:.3f} ms: "
            f"{_hbm(moved, ms)}")
    small = hc.alloc((4,), fill=1.0)
    check(hm._strategy("allreduce", int(small.nbytes)) == "flat"
          and torch.equal(hc.allreduce(small, MPI.SUM),
                          torch.full_like(small, float(n))),
          "han's small message did not go flat")
    lines.append("han's 128 B allreduce went flat (the next component) "
                 "and = numpy; no gain is claimed: one card has no tier "
                 "to save")
    for c in (hc, xc, xa):
        c.free()
    # adapt: 1 MB segments of the 32 MB rows, against the blocking calls
    am = adapt.AdaptModule(w, SES_SEG)
    fired = []
    req = am.ibcast_adapt(x, root=3, on_complete=lambda r: fired.append(1))
    req.wait()
    req.wait()
    check(len(req._segments) == LOCAL_ELEMS // SES_SEG and fired == [1],
          f"adapt ibcast: {len(req._segments)} segments, callback "
          f"{len(fired)} times")
    check(_bits(req.get(), w.bcast(x, root=3)), "adapt ibcast vs bcast")
    fired.clear()
    with var.scope(direct):
        req = am.ireduce_adapt(x, MPI.SUM, 0,
                               on_complete=lambda r: fired.append(1))
        req.wait()
        check(fired == [1] and _bits(req.get(), w.allreduce(x, MPI.SUM)),
              "adapt ireduce vs the blocking allreduce (direct, bit for "
              "bit)")

    def span(fn):
        def run():
            r = fn()
            while not r.test()[0]:
                pass
        return device_ms(run, iters=5, warmup=1)

    b_ms = device_ms(lambda: w.bcast(x, root=3), iters=10, warmup=2)
    ab_ms = span(lambda: am.ibcast_adapt(x, root=3))
    with var.scope(direct):
        ar_ms = span(lambda: am.ireduce_adapt(x, MPI.SUM, 0))
    lines.append(
        f"adapt at {LOCAL_ELEMS * 4 >> 20} MB per rank in "
        f"{LOCAL_ELEMS // SES_SEG} segments of {SES_SEG * 4 >> 20} MB: "
        f"ibcast_adapt = bcast and ireduce_adapt = the direct allreduce "
        f"bit for bit, each callback fired once; ibcast_adapt {ab_ms:.3f} "
        f"ms span (CUDA events, with the host's dispatch of every "
        f"segment) against bcast {b_ms:.3f} ms device; ireduce_adapt "
        f"{ar_ms:.3f} ms span against direct allreduce {d_ms:.3f} ms: "
        f"{_hbm(moved, ar_ms)}")
    return lines


def _ses_accel(w, x) -> list:
    """15(d): acoll's detection and the accelerator surface."""
    dev = w.device
    detected = var.var_get("coll_acoll_detected")
    seg = var.var_get("coll_torch_segsize")
    src = var.var_source("coll_torch_segsize")
    check(detected == "" and seg == 1 << 20 and src == "default",
          f"acoll on {torch.cuda.get_device_name(dev)}: detected "
          f"{detected!r}, coll_torch_segsize {seg} ({src})")
    mod = accelerator.current_module()
    z = mod.mem_alloc((w.size, 1024), torch.float32, device=dev)
    check(z.device == dev and not bool(z.any()), "mem_alloc")
    torch.cuda._sleep(20_000_000)
    y = z + 1
    mod.event_synchronize([y])
    check(torch.cuda.current_stream(dev).query(), "event_synchronize "
          "returned before the queued kernel ended")
    h = mod.get_ipc_handle(x)
    check(mod.open_ipc_handle(h).tensor is x, "ipc round trip")
    mod.close_ipc_handle(h)
    try:
        mod.open_ipc_handle(h)
        check(False, "a closed ipc handle opened")
    except MPI.MPIError:
        pass
    info = mod.get_device_info()
    attrs = mod.get_device_attributes(dev)
    check(info == ("cuda", torch.cuda.device_count())
          and attrs["name"] == torch.cuda.get_device_name(dev)
          and attrs["sm_count"] > 0 and attrs["total_memory"] > 0,
          f"device info {info}, attributes {attrs}")
    check(mod.device_can_access_peer(dev, dev), "peer access to itself")
    ms = attrs["memory_stats"] or {}
    return [
        f"coll_acoll_detected {detected!r} on "
        f"{torch.cuda.get_device_name(dev)} (no table row: no hint "
        f"installed); coll_torch_segsize {seg} from its {src}",
        f"mem_alloc on {dev}; event_synchronize after a queued sleep "
        f"kernel; get_ipc_handle -> open_ipc_handle (the same tensor) -> "
        f"close_ipc_handle (reopen raises); get_device_info {info}; "
        f"get_device_attributes: {attrs['name']}, {attrs['sm_count']} SMs, "
        f"{attrs['total_memory'] / 2 ** 30:.1f} GiB, compute capability "
        f"{attrs['compute_capability']}, allocated "
        f"{ms.get('allocated_bytes.all.current', 0) / 2 ** 30:.2f} GiB; "
        f"device_can_access_peer({dev}, {dev}) True"]


def phase_sessions_world(w, smi: str) -> float:
    """Phase 15(a)-(d) on the live 8-rank world, before phase 14 fails a
    rank of it. Returns the seconds it took."""
    t0 = time.perf_counter()
    dev = w.device
    g = torch.Generator(device=dev).manual_seed(SES_SEED)
    x = torch.randn((w.size, LOCAL_ELEMS), device=dev, generator=g)
    xh = x.cpu().numpy()
    for part in (_ses_sessions(w, x, xh, smi), _ses_dpm(w, x, xh, smi),
                 _ses_compose(w, x, xh, smi), _ses_accel(w, x),
                 _ses_fresh(smi)):
        for line in part:
            phase("sessions", f"{line} | {smi}")
    return time.perf_counter() - t0


def _bridge_rank(role: str, port_file: str, report: str) -> int:
    """A rank of one of phase 15(e)'s two 2-rank jobs: rendezvous with
    the other job through dpm_perrank and exchange messages both ways,
    non-roots included; one message is a CUDA tensor."""
    from ompi_tpu_torch.core import dpm_perrank as dpm
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = w.device
    t0 = time.perf_counter()
    if role == "accept":
        port = dpm.open_port() if r == 0 else None
        if r == 0:
            with open(port_file + ".tmp", "w") as f:
                f.write(port)
            os.rename(port_file + ".tmp", port_file)
        port = w.bcast(port, root=0)
        ic = dpm.comm_accept(port, w, root=0, timeout=SES_JOB_TIMEOUT - 10)
    else:
        deadline = time.monotonic() + SES_JOB_TIMEOUT - 10
        while not os.path.exists(port_file):
            check(time.monotonic() < deadline, "no port file")
            time.sleep(0.02)
        port = open(port_file).read().strip()
        ic = dpm.comm_connect(port, w, root=0)
    rdv_ms = (time.perf_counter() - t0) * 1e3
    check(ic.remote_size == n, f"remote size {ic.remote_size}")
    mine = 100 if role == "accept" else 200
    other = 300 - mine
    ic.send(np.array([mine + r, r]), remote_rank=r, tag=7)
    data, st = ic.recv(source=r, tag=7, timeout=30)
    check(data[0] == other + r and st.source == r, f"{data}, {st.source}")
    t = torch.arange(1 << 20, device=dev, dtype=torch.float32) + mine + r
    t1 = time.perf_counter()
    ic.send(t, remote_rank=r, tag=9)
    got, _ = ic.recv(source=r, tag=9, timeout=30)
    cross_ms = (time.perf_counter() - t1) * 1e3
    want = (torch.arange(1 << 20, dtype=torch.float32) + other + r).numpy()
    check(isinstance(got, np.ndarray) and _bits(got, want),
          f"the CUDA tensor crossed as {type(got).__name__}")
    if r == 0:
        for rr in range(ic.remote_size):
            ic.send({"from": role, "to": rr}, remote_rank=rr, tag=8)
    obj, _ = ic.recv(source=0, tag=8, timeout=30)
    check(obj["to"] == r and obj["from"] != role, f"{obj}")
    ic.disconnect()
    if role == "accept" and r == 0:
        dpm.close_port(port)
        with open(report, "w") as fh:
            json.dump({"lines": [
                f"two 2-rank jobs on {dev}: dpm_perrank rendezvous in "
                f"{rdv_ms:.1f} ms (accept side, rank 0), messages both "
                f"ways from every rank (root-relayed), a 4 MB CUDA tensor "
                f"arrived as numpy with the same bits (send + recv "
                f"{cross_ms:.1f} ms, host clock)"]}, fh)
    MPI.Finalize()
    print(f"OK bridge {role} rank={r}/{n}", flush=True)
    return 0


def _sessions_rank(report: str) -> int:
    """A rank of phase 15(e)'s 3-rank sessions job (p23 on CUDA
    tensors)."""
    from ompi_tpu_torch.core.rankcomm import counters
    from ompi_tpu_torch.runtime.session import Session
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    dev = w.device
    s1, s2 = Session(), Session()
    check(int(s1.get_pset_info("mpi://WORLD").get("size")) == n
          and s1.get_nth_pset(1) == "mpi://SELF", "psets")
    grp = tuple(range(n))
    c1 = s1.comm_create_from_group(s1.group_from_pset("mpi://WORLD"),
                                   tag="work")
    c2 = s2.comm_create_from_group(s2.group_from_pset("mpi://WORLD"),
                                   tag="work")
    check(c1.cid == ("s", "work", grp, 0) and c2.cid == ("s", "work", grp, 1)
          and c1.rank() == c2.rank() == r, f"cids {c1.cid}, {c2.cid}")
    base = (torch.arange(LOCAL_ELEMS, device=dev) % 1024).float()
    tri = n * (n - 1) / 2
    before = counters["coll_device"]
    t0 = time.perf_counter()
    y1 = c1.allreduce(base + r, MPI.SUM)
    y2 = c2.allreduce(base * 2 + r, MPI.SUM)
    torch.cuda.synchronize()
    two_ms = (time.perf_counter() - t0) * 1e3
    check(counters["coll_device"] == before + 2, "the device tier missed")
    check(torch.equal(y1, base * n + tri)
          and torch.equal(y2, base * 2 * n + tri), "session allreduces")
    # independent traffic on one tag: a CUDA tensor ring on each comm
    for c, k in ((c1, 1.0), (c2, 2.0)):
        c.send(base * k + r, (r + 1) % n, tag=3)
        got, _ = c.recv((r - 1) % n, tag=3)
        check(got.device == dev and torch.equal(got, base * k + (r - 1) % n),
              "session ring")
    c2d = c2.dup()
    check(torch.equal(c2d.allreduce(base, MPI.SUM), base * n), "dup")
    w.barrier()
    s1.finalize()
    check(c1._freed, "s1's comm survived its finalize")
    check(torch.equal(c2.allreduce(base, MPI.SUM), base * n)
          and torch.equal(w.allreduce(base, MPI.SUM), base * n),
          "s2 and the world after s1's finalize")
    s2.finalize()
    check(c2._freed and c2d._freed, "s2's family survived")
    w.barrier()
    if r == 0:
        with open(report, "w") as fh:
            json.dump({"lines": [
                f"{n}-rank job on {dev}: two sessions, tag 'work', CIDs "
                f"{c1.cid} and {c2.cid}; their {LOCAL_ELEMS * 4 >> 20} MB "
                f"CUDA allreduces took the device tier (2 launches, "
                f"{two_ms:.1f} ms host clock for both) = exact sums; "
                f"independent CUDA tensor rings on the same tag; session 1 "
                f"finalized while session 2, its dup and the world went "
                f"on"]}, fh)
    MPI.Finalize()
    print(f"OK sessions rank={r}/{n}", flush=True)
    return 0


def phase_sessions_job(smi: str, world_s: float) -> None:
    """Phase 15(e): the two bridged 2-rank jobs and the 3-rank sessions
    job, all three at once, each under its own limit."""
    import signal
    import tempfile
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    mpirun = os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py")
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        port_file = os.path.join(tmp, "port.txt")
        jobs = []
        for name, n, args in (
                ("bridge accept", 2,
                 ["--bridge-rank", "accept", port_file,
                  os.path.join(tmp, "bridge.json")]),
                ("bridge connect", 2,
                 ["--bridge-rank", "connect", port_file,
                  os.path.join(tmp, "unused.json")]),
                ("sessions", 3,
                 ["--sessions-rank", os.path.join(tmp, "sessions.json")])):
            cmd = [sys.executable, mpirun, "--per-rank", "-n", str(n),
                   "--timeout", str(SES_JOB_TIMEOUT), me] + args
            jobs.append((name, n, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=root, start_new_session=True)))
        outs = []
        deadline = time.monotonic() + SES_JOB_TIMEOUT + 5
        for name, n, p in jobs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                outs.append(("", f"{name}: killed at the phase's limit"))
        for _name, _n, p in jobs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        for (name, n, p), (out, err) in zip(jobs, outs):
            oks = out.count("OK ")
            if p.returncode != 0 or oks != n:
                sys.stderr.write(err[-6000:])
                check(False, f"{name} job rc={p.returncode}, {oks} of {n} "
                      f"ranks OK:\n{out[-3000:]}")
        lines = []
        for rep in ("bridge.json", "sessions.json"):
            with open(os.path.join(tmp, rep)) as f:
                lines += json.load(f)["lines"]
    job_s = time.perf_counter() - t0
    check(job_s < SES_JOB_PHASE_S, f"the per-rank part took {job_s:.1f} s")
    for line in lines:
        phase("sessions", f"{line} | {smi}")
    phase("sessions", f"per-rank part {job_s:.1f} s (limit "
          f"{SES_JOB_PHASE_S} s); phase 15 took {world_s + job_s:.1f} s "
          f"| {smi}")


# -- phase 16 ----------------------------------------------------------
OSC_SEED = 1600
OSC_ROWS = 8                   # host numpy rows per fold, 32 MB fp32 each
OSC_SMALL = 1 << 20            # uint32 window, dynamic regions (elements)
OSC_JOB_TIMEOUT = 60           # seconds each per-rank job may take
OSC_JOB_PHASE_S = 90           # phase 16 must end within this
OSC_ENTRY = ("ompi_tpu_reduce_local", "ompi_tpu_pack_runs_rows",
             "ompi_tpu_unpack_runs_rows", "ompi_tpu_match_send",
             "ompi_tpu_match_take", "ompi_tpu_match_post")
OSC_HB = (("mpi_base_ft_hb_period", 0.1), ("mpi_base_ft_hb_timeout", 0.8),
          ("mpi_base_ft_hb_miss", 3))


class _CountingLib:
    """The port's native library with a count per entry point called
    through it. Phase 16 swaps it in for ``native.get_lib`` in this
    process (as ``tests/test_native_runtime.py`` patches ``get_lib``):
    the package itself keeps no counter."""

    def __init__(self, lib):
        self._lib = lib
        self.counts = dict.fromkeys(OSC_ENTRY, 0)

    def __getattr__(self, name):
        f = getattr(self._lib, name)
        if name not in self.counts:
            return f

        def counted(*args):
            self.counts[name] += 1
            return f(*args)
        return counted


def _osc_native_checks(w) -> list:
    """16(a): the native host library on the paths that call it."""
    import functools
    from ompi_tpu_torch import native as N
    from ompi_tpu_torch.coll import basic
    from ompi_tpu_torch.core import op as op_mod
    from ompi_tpu_torch.core import rankcomm
    from ompi_tpu_torch.native import loader
    check(N.native_available(), f"the native library did not build: "
          f"{N.build_error()}")
    path = loader.lib_path()
    check(path.parent == loader.BUILD_DIR and path.exists(),
          f"native library at {path}")
    lines = [f"native library {path.name} in {loader.BUILD_DIR.name}/ "
             f"(g++ -O3 of native/*.cpp), built in "
             f"{loader.build_seconds():.2f} s in this process, ABI "
             f"{N.get_lib().ompi_tpu_native_abi()}"]
    lib = _CountingLib(N.get_lib())
    real = N.get_lib
    N.get_lib = lambda: lib
    try:
        rng = np.random.default_rng(OSC_SEED)
        rows = rng.standard_normal((OSC_ROWS, LOCAL_ELEMS), dtype=np.float32)
        times = []
        for op in (MPI.SUM, MPI.MAX):
            npfn = op_mod.NP_COMBINERS[op.name]
            nat = lambda op=op: functools.reduce(
                lambda a, b: rankcomm._apply(op, a, b), rows)
            ref = lambda npfn=npfn: functools.reduce(npfn, rows)
            check(_bits(nat(), ref()), f"rankcomm._apply {op.name}: native "
                  f"against numpy")
            times.append((f"host fold {op.name}", host_ms(nat, 3),
                          host_ms(ref, 3)))
        del rows
        ints = rng.integers(-2 ** 31, 2 ** 31 - 1, (OSC_ROWS, LOCAL_ELEMS),
                            dtype=np.int32)
        for op in (MPI.BAND, MPI.BXOR, MPI.LAND):
            npfn = op_mod.NP_COMBINERS[op.name]
            nat = lambda op=op: basic._np_fold(op, ints)
            ref = lambda npfn=npfn: functools.reduce(npfn, ints)
            check(_bits(nat(), ref()), f"coll/basic {op.name} on int32")
            times.append((f"basic {op.name} int32", host_ms(nat, 3),
                          host_ms(ref, 3)))
        del ints
        # reduce_local: 10 dtypes x 10 ops, NaNs in the float operands
        ops = ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR", "LAND",
               "LOR", "LXOR")
        dts = (np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
               np.uint32, np.uint64, np.float32, np.float64)
        native_cases = 0
        for dt in dts:
            if np.dtype(dt).kind == "f":
                a = rng.standard_normal(OSC_SMALL).astype(dt)
                b = rng.standard_normal(OSC_SMALL).astype(dt)
                a[::7], b[3::11] = np.nan, np.nan
            else:
                info = np.iinfo(dt)
                a = rng.integers(info.min, info.max, OSC_SMALL, dtype=dt,
                                 endpoint=True)
                b = rng.integers(info.min, info.max, OSC_SMALL, dtype=dt,
                                 endpoint=True)
            for name in ops:
                if np.dtype(dt).kind == "f" and name.startswith("B"):
                    continue             # no bitwise op on floats
                op = getattr(MPI, name)
                before = lib.counts["ompi_tpu_reduce_local"]
                got = op_mod.reduce_local(a, b, op)
                want = op_mod.np_combiner(op)(a, b)
                native_cases += lib.counts["ompi_tpu_reduce_local"] > before
                check(_bits(got, want), f"reduce_local {name} on "
                      f"{np.dtype(dt).name}")
        check(native_cases == len(dts) * len(ops) - 6,
              f"{native_cases} reduce_local cases took the C++ table")
        lines.append(f"reduce_local: {len(dts)} dtypes x {len(ops)} ops at "
                     f"{OSC_SMALL} elements (NaNs in the float operands; "
                     f"no bitwise op on the 2 float dtypes): all "
                     f"{native_cases} through the C++ table, bit for bit "
                     f"= the numpy route")
        # the convertor on a (4096, 2048) host matrix
        L = MAT[0] * MAT[1]
        m = rng.standard_normal(L, dtype=np.float32)
        types = {"vector(4096, 1024, 2048)":
                 MPI.FLOAT.create_vector(MAT[0], 1024, MAT[1]).commit(),
                 "indexed (4096 blocks of 1..1024)":
                 MPI.FLOAT.create_indexed(
                     list(rng.integers(1, 1025, MAT[0])),
                     list(np.arange(MAT[0]) * MAT[1])).commit()}
        for name, t in types.items():
            idx = t.flat_indices(1)
            p = convertor.pack(m, t, 1)
            check(_bits(p, m[idx]), f"{name}: native pack")
            u = convertor.unpack(np.zeros_like(m), p, t, 1)
            fancy = np.zeros_like(m)
            fancy[idx] = m[idx]
            check(_bits(u, fancy), f"{name}: native unpack")
            out = np.zeros_like(m)
            times.append((f"pack {name}", host_ms(
                lambda t=t: convertor.pack(m, t, 1), 5),
                host_ms(lambda idx=idx: np.ascontiguousarray(m[idx]), 5)))
            times.append((f"unpack {name}", host_ms(
                lambda t=t, p=p: convertor.unpack(out, p, t, 1), 5),
                host_ms(lambda idx=idx, p=p: out.__setitem__(idx, p), 5)))
        # matching: the 8 x 32 MB ring and 256 wildcards, native on and off
        g = torch.Generator(device="cuda").manual_seed(OSC_SEED)
        x = torch.randn((w.size, LOCAL_ELEMS), device="cuda", generator=g)
        xh = x.cpu().numpy()
        engines = {}
        for label, off in (("python", "1"), ("native", None)):
            if off:
                os.environ["OMPI_TPU_TORCH_DISABLE_NATIVE_MATCH"] = off
            try:
                d = w.dup()
                d.send(x[0, :2], src=0, dest=1, tag=0)   # makes the engine
                d.recv(0, 0, dst=1)
            finally:
                os.environ.pop("OMPI_TPU_TORCH_DISABLE_NATIVE_MATCH", None)
            check((d._pml._lib is not None) == (label == "native"),
                  f"{label} matching engine")
            engines[label] = d
        seen = {}
        for label, d in engines.items():
            order = []
            for sends_first in (False, True):
                got, sts = _ring(d, x, 1, sends_first)
                check(all(_bits(o, xh[(r - 1) % w.size])
                          for r, o in enumerate(got)),
                      f"{label} ring (sends first {sends_first})")
                order += [(s.source, s.tag) for s in sts]
            small = torch.ones(2, device="cuda")
            for i in range(256):
                d.send(small * i, src=(i * 3) % w.size, dest=0, tag=i % 7)
            us = []
            for _ in range(256):
                t0 = time.perf_counter()
                data, st = d.recv(MPI.ANY_SOURCE, MPI.ANY_TAG, dst=0)
                us.append((time.perf_counter() - t0) * 1e6)
                order.append((st.source, st.tag, float(data[0])))
            seen[label] = order
            ring_ms = device_ms(lambda d=d: _ring(d, x, 3, False), iters=5,
                                warmup=1)
            times.append((f"{label} matching: ring ms / wildcard us",
                          ring_ms, statistics.median(us)))
        check(seen["python"] == seen["native"], "matching order differs "
              "between the native and the Python engine")
        for d in engines.values():
            d.free()
        del x
    finally:
        N.get_lib = real
    counts = lib.counts
    check(all(counts.values()), f"a native entry point was never called: "
          f"{counts}")
    lines.append("native calls made through the library in this phase: "
                 + ", ".join(f"{k[9:]} {v}" for k, v in counts.items()))
    lines.append("ring order, statuses and 256 wildcard matches: the "
                 "native engine = the Python engine")
    for what, a, b in times:
        lines.append(f"{what}: native {a:.3f}, numpy/python {b:.3f} "
                     f"(host ms, median)" if "matching" not in what else
                     f"{what}: {a:.4f} ms (device), {b:.2f} us (host, "
                     f"median of 256)")
    return lines


def _osc_win_checks(w) -> list:
    """16(b): the single-controller Win on cuda:0, 8 x 32 MB fp32."""
    dev = torch.device("cuda", 0)
    n = w.size
    g = torch.Generator(device=dev).manual_seed(OSC_SEED + 1)
    x = torch.randn((n, LOCAL_ELEMS), device=dev, generator=g)
    xh = x.cpu().numpy()
    win = MPI.Win.allocate(w, LOCAL_ELEMS, np.float32)
    on_card = lambda wn: (wn.buffer.device == dev
                          and wn.buffer.shape[0] == n)
    check(on_card(win), f"window on {win.buffer.device}")
    win.fence()
    for r in range(n):
        win.put(x[r], (r + 1) % n)
    win.fence()
    check(all(torch.equal(win.buffer[(r + 1) % n], x[r]) for r in range(n)),
          "fenced put ring")
    check(_bits(win.get(3, 5, 1000), xh[2, 5:1005]), "get")
    row = xh[3].copy()                     # row 4 holds x[3]
    for name, inc, fn in (("SUM", 5, np.add), ("MAX", 6, np.maximum),
                          ("REPLACE", 7, lambda a, b: b),
                          ("NO_OP", 0, lambda a, b: a)):
        win.accumulate(x[inc], 4, getattr(MPI, name))
        want = fn(row, xh[inc])
        got = win.get(4)
        if name == "SUM":
            _close(got, want, 1e-5, 0.0, "accumulate SUM")
        else:
            check(_bits(got, want), f"accumulate {name}")
        row = got
    # uint32: the signed twin through Op.__call__, exact
    rng = np.random.default_rng(OSC_SEED)
    u = rng.integers(0, 2 ** 32 - 1, (3, OSC_SMALL), dtype=np.uint32,
                     endpoint=True)
    uw = MPI.Win.allocate(w, OSC_SMALL, np.uint32)
    check(on_card(uw) and uw.buffer.dtype == torch.uint32, "uint32 window")
    uw.put(u[0], 1)
    cur = u[0]
    ud = torch.from_numpy(u).to(dev)
    for name, k, fn in (("SUM", 1, np.add), ("MAX", 2, np.maximum),
                        ("REPLACE", 1, lambda a, b: b),
                        ("NO_OP", 2, lambda a, b: a)):
        uw.accumulate(ud[k], 1, getattr(MPI, name))
        cur = fn(cur, u[k])
        check(_bits(uw.get(1), cur), f"uint32 accumulate {name}")
    # get_accumulate, fetch_and_op, compare_and_swap
    before = win.get(2, 7, OSC_SMALL)
    old = win.get_accumulate(x[1, :OSC_SMALL], 2, MPI.SUM, target_disp=7)
    check(_bits(old, before), "get_accumulate's fetch")
    _close(win.get(2, 7, OSC_SMALL), before + xh[1, :OSC_SMALL], 1e-5, 0.0,
           "get_accumulate SUM")
    v0 = win.get(6, 11, 1)[0]
    check(win.fetch_and_op(3.0, 6, MPI.SUM, target_disp=11) == v0
          and win.get(6, 11, 1)[0] == np.float32(v0 + np.float32(3.0)),
          "fetch_and_op")
    v1 = win.get(6, 11, 1)[0]
    check(win.compare_and_swap(42.0, v1, 6, 11) == v1
          and win.get(6, 11, 1)[0] == 42.0, "compare_and_swap (swap)")
    check(win.compare_and_swap(7.0, 1.5, 6, 11) == 42.0
          and win.get(6, 11, 1)[0] == 42.0, "compare_and_swap (no swap)")
    # requests, PSCW, lock/unlock
    req = win.rput(x[2], 0)
    racc = win.raccumulate(x[3], 0, MPI.MAX)
    check(req._event is not None, "rput did not complete on an event")
    req.wait()
    racc.wait()
    check(_bits(win.get(0), np.maximum(xh[2], xh[3])), "rput + raccumulate")
    grp = w.group
    win.post(grp)
    win.start(grp)
    win.put(x[4], 1)
    win.complete()
    win.wait()
    check(win.test() and _bits(win.get(1), xh[4]), "PSCW")
    win.lock(5)
    win.accumulate(x[5], 5, MPI.REPLACE)
    win.unlock(5)
    check(_bits(win.get(5), xh[5]), "lock / unlock")
    dyn = MPI.Win.create_dynamic(w, np.float32)
    b0 = dyn.attach(OSC_SMALL)
    dyn.put(x[0, :OSC_SMALL], 5, b0)
    b1 = dyn.attach(OSC_SMALL)
    dyn.put(x[1, :OSC_SMALL], 5, b1)
    check(b0 == 0 and b1 == OSC_SMALL and on_card(dyn)
          and _bits(dyn.get(5), np.concatenate([xh[0, :OSC_SMALL],
                                                xh[1, :OSC_SMALL]])),
          "attach")
    check(on_card(win) and on_card(uw), "a window row left cuda:0")
    # device ms: 32 MB from a CUDA origin and from a numpy origin
    nb = LOCAL_ELEMS * 4
    put_b, acc_b = 2 * nb / HBM_BYTES_PER_S * 1e3, 3 * nb / HBM_BYTES_PER_S \
        * 1e3
    ms = {"put cuda": device_ms(lambda: win.put(x[1], 2)),
          "acc cuda": device_ms(lambda: win.accumulate(x[1], 2, MPI.SUM)),
          "put numpy": device_ms(lambda: win.put(xh[1], 2), iters=10),
          "acc numpy": device_ms(lambda: win.accumulate(xh[1], 2, MPI.SUM),
                                 iters=10)}
    for wn in (win, uw, dyn):
        wn.free()
    del x, ud
    torch.cuda.empty_cache()
    return [
        "Win on cuda:0, 8 x 32 MB fp32 (256 MB stacked, every row on "
        "cuda:0 after every call): fenced put ring, get, accumulate SUM "
        "(rtol 1e-5) / MAX / REPLACE / NO_OP, uint32 SUM / MAX / REPLACE / "
        "NO_OP exact, get_accumulate, fetch_and_op, compare_and_swap "
        "(swap and no swap), rput + raccumulate on a CUDA event, PSCW, "
        "lock / unlock, attach: all = numpy",
        f"32 MB put from a CUDA origin {ms['put cuda']:.4f} ms (bound "
        f"{put_b:.4f} ms, 64 MiB over 3.35 TB/s: {put_b / ms['put cuda']:.1%}"
        f" of HBM); accumulate SUM {ms['acc cuda']:.4f} ms (bound "
        f"{acc_b:.4f} ms, 96 MiB: {acc_b / ms['acc cuda']:.1%}); from a numpy "
        f"origin (one pageable host-to-device copy): put "
        f"{ms['put numpy']:.4f} ms, accumulate {ms['acc numpy']:.4f} ms "
        f"(device ms, CUDA events, median)"]


def phase_onesided_world(w, smi: str) -> float:
    """Phase 16(a) and (b) on the live 8-rank world on cuda:0."""
    t0 = time.perf_counter()
    for line in _osc_native_checks(w) + _osc_win_checks(w):
        phase("onesided", f"{line} | {smi}")
    return time.perf_counter() - t0


def _osc_fresh_check(report: str) -> int:
    """16(b)'s DtoH count in a process of its own (``--osc-fresh-check``;
    see ``_fresh_check``): a 32 MB put and accumulate from a CUDA origin
    on the 8-row world's window, each warmed once, then counted under
    the profiler, with a ``.cpu()`` control."""
    dev = torch.device("cuda", 0)
    MPI.Init(devices=[dev] * N_RANKS)
    w = MPI.get_comm_world()
    win = MPI.Win.allocate(w, LOCAL_ELEMS, np.float32)
    x = torch.randn((2, LOCAL_ELEMS), device=dev)
    calls = {"put": lambda: win.put(x[0], 3),
             "accumulate SUM": lambda: win.accumulate(x[1], 3, MPI.SUM),
             "accumulate MAX": lambda: win.accumulate(x[1], 4, MPI.MAX),
             "rput": lambda: win.rput(x[0], 5).wait(),
             "raccumulate": lambda: win.raccumulate(x[1], 5, MPI.SUM)
             .wait()}
    counts = {}
    for name, fn in calls.items():
        fn()
        counts[name] = _dtoh_events(fn)
    t = torch.ones(1024, device=dev)
    with open(report, "w") as fh:
        json.dump({"counts": counts,
                   "control": _dtoh_events(lambda: t.cpu())}, fh)
    win.free()
    MPI.Finalize()
    return 0


def _osc_p43(w, comp: str, out_dir: str) -> list:
    """The port's p43 drill at 32 MB per window, CUDA origins; rank 0's
    lines (host ms per op) and, on shm, its telemetry dump and flight
    record."""
    from ompi_tpu_torch import telemetry
    from ompi_tpu_torch.api import mpi as api
    from ompi_tpu_torch.telemetry import flightrec
    r, n = w.rank(), w.size
    nxt, prv = (r + 1) % n, (r - 1) % n
    full = np.random.default_rng(OSC_SEED + 43).standard_normal(
        (n, LOCAL_ELEMS), dtype=np.float32)
    origin = torch.from_numpy(full).to(w.device)
    p0 = pvar.pvar_read("osc_puts")
    win = api.Win_allocate(w, LOCAL_ELEMS, np.float32, name="p43",
                           force=comp)
    check(win.component == comp, win.component)
    win.local[:] = 0.0
    win.fence()
    win.put(origin[r], nxt)
    win.fence()
    check(np.array_equal(win.local, full[prv]), "put ring")
    lines = []
    if comp == "shm" and r == 0:
        path = flightrec.record("osc_check", {"rank": r})
        with open(path) as f:
            epochs = json.load(f)["osc_epochs"]
        check(epochs and epochs[0]["fenced"], f"osc_epochs {epochs}")
        lines.append(f"flight record {os.path.basename(path)}: osc_epochs "
                     f"{epochs}")
    win.fence()
    view = win.get((r + 2) % n, 0, LOCAL_ELEMS)
    got = np.asarray(view).copy()
    win.fence()
    check(np.array_equal(got, full[(r + 1) % n]), "get ring")
    if comp == "shm":
        check(not np.asarray(view).flags.owndata, "shm get copied")
    del view
    win.fence()
    win.local[:] = 0.0
    win.fence()
    win.accumulate(origin[r], 0, op="sum")
    win.accumulate(origin[r].abs(), 1, op="max")
    win.fence()
    if r == 0:
        check(np.allclose(win.local, full.sum(axis=0, dtype=np.float32),
                          rtol=1e-4, atol=1e-4), "sum fan-in")
    if r == 1:
        check(np.array_equal(win.local, np.abs(full).max(axis=0)),
              "max fan-in")
    w.barrier()                          # the checks read before the
    win.lock(nxt)                        # passive puts land
    win.put(origin[r] * 2.0, nxt)
    win.flush(nxt)
    win.unlock(nxt)
    w.barrier()
    check(np.array_equal(win.local, full[prv] * 2.0), "passive put")
    check(pvar.pvar_read("osc_puts") - p0 >= 2, "osc_puts")
    # host ms per op at 32 MB (medians of 3, inside one fence epoch)
    win.fence()
    ms = {}
    for kind, fn in (("put", lambda: win.put(origin[r], nxt)),
                     ("get", lambda: win.get(nxt, 0, LOCAL_ELEMS)),
                     ("acc", lambda: win.accumulate(origin[r].abs(), nxt,
                                                    op="max"))):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        ms[kind] = statistics.median(ts)
    win.fence()
    if comp == "shm" and r == 0:
        path = os.path.join(out_dir, "telemetry_0.json")
        telemetry.dump(path, rank=0)
        with open(path) as f:
            osc = json.load(f).get("osc", {})
        check(osc.get("puts", 0) >= 5 and osc.get("fences", 0) >= 8,
              f"telemetry dump osc section {osc}")
        lines.append(f"telemetry dump: osc section puts {osc['puts']}, gets "
                     f"{osc['gets']}, accs {osc['accs']}, fences "
                     f"{osc['fences']}, windows_shm {osc['windows_shm']}")
    w.barrier()
    win.free()
    lines.insert(0, f"p43 {comp}, 4 ranks, 32 MB per window, CUDA origins "
                 f"staged with .cpu(): put/get ring, sum/max fan-in, "
                 f"passive put = numpy on every rank; rank 0 host ms per "
                 f"32 MB op: put {ms['put']:.2f}, get {ms['get']:.2f}, "
                 f"accumulate {ms['acc']:.2f} (median of 3)")
    return lines


def _osc_p13(w) -> list:
    """The port's p13 on 3 ranks (one CUDA origin in the first put)."""
    from ompi_tpu_torch.osc.perrank import LOCK_EXCLUSIVE, RankWindow
    r, n = w.rank(), w.size
    win = RankWindow(w, 16, np.float32)
    win.fence()
    win.put(torch.tensor([float(r + 1)], device=w.device), target=0, disp=r)
    win.fence()
    if r == 0:
        check(np.allclose(win.local[:n], np.arange(1, n + 1)), "p13 put")
    win.fence()
    win.accumulate([1.0], target=n - 1, disp=8, op="sum")
    win.fence()
    if r == n - 1:
        check(win.local[8] == float(n), "p13 accumulate")
    check(np.allclose(win.get(target=0, disp=0, count=n),
                      np.arange(1, n + 1)), "p13 get")
    old = win.fetch_and_op(1.0, target=0, disp=12, op="sum")
    check(0.0 <= old < n, "p13 fetch_and_op")
    win.fence()
    prev = win.compare_and_swap(0.0, float(r + 1), target=0, disp=15)
    check(w.allreduce(1 if prev == 0.0 else 0, MPI.SUM) == 1, "p13 CAS")
    win.fence()
    for _ in range(3):
        win.lock(1, LOCK_EXCLUSIVE)
        cur = win.get(target=1, disp=3, count=1)[0]
        win.put([cur + 1.0], target=1, disp=3)
        win.unlock(1)
    w.barrier()
    if r == 1:
        check(win.local[3] == float(3 * n), "p13 passive counter")
    win.free()
    w4 = RankWindow(w, 4, np.float64)
    w4.fence()
    right = (r + 1) % n
    w4.rput(np.array([10.0 + r, 20.0 + r]), right, disp=1).wait()
    ra = w4.raccumulate(np.array([0.25, 0.25]), right, disp=1, op="sum")
    ra.wait()
    g = w4.rget(right, disp=1, count=2)
    check(g.get()[0] == 10.25 + r, "p13 request RMA")
    w4.fence()
    w4.free()
    return ["p13, 3 ranks: put (a CUDA origin), accumulate, get, "
            "fetch_and_op, compare_and_swap (one winner), passive "
            "counter, rput / raccumulate / rget: every rank OK"]


def _osc_p44(w) -> list:
    """The port's p44: rank 2 SIGKILLs itself inside an exposure epoch;
    the survivors get ERR_PROC_FAILED from fence and from a put to it,
    revoke, free, shrink and allocate again."""
    import signal
    from ompi_tpu_torch.api import mpi as api
    r, n = w.rank(), w.size
    victim = 2
    nxt, prv = (r + 1) % n, (r - 1) % n
    api.Comm_set_errhandler(w, MPI.ERRORS_RETURN)
    w.barrier()
    full = np.random.default_rng(OSC_SEED + 44).standard_normal(
        (n, 1 << 14), dtype=np.float32)
    win = api.Win_allocate(w, 1 << 14, np.float32, name="p44", force="shm")
    win.local[:] = 0.0
    win.fence()
    win.put(torch.from_numpy(full[r]).to(w.device), nxt)
    win.fence()
    check(np.array_equal(win.local, full[prv]), "p44 healthy ring")
    if r == victim:
        os.kill(os.getpid(), signal.SIGKILL)
    t0 = time.perf_counter()
    deadline = time.monotonic() + 15
    while w.get_failed() != [victim]:
        check(time.monotonic() < deadline, f"p44 failed {w.get_failed()}")
        time.sleep(0.02)
    detect_ms = (time.perf_counter() - t0) * 1e3
    for what, fn in (("fence", win.fence),
                     ("put", lambda: win.put(full[r], victim))):
        try:
            fn()
            check(False, f"p44 {what} over a dead rank did not error")
        except MPI.MPIError as e:
            check(e.error_class == MPI.ERR_PROC_FAILED, f"p44 {what}: {e}")
    check(pvar.pvar_read("osc_ft_failed_epochs") >= 1, "p44 torn epoch")
    if r == 0:
        MPI.MPIX_Comm_revoke(w)
    deadline = time.monotonic() + 10
    while not MPI.MPIX_Comm_is_revoked(w):
        check(time.monotonic() < deadline, "p44 revoke")
        time.sleep(0.02)
    try:
        win.free()
    except MPI.MPIError:
        pass
    s = MPI.MPIX_Comm_shrink(w)
    n2, sr = s.size, s.rank()
    check(n2 == n - 1 and sr == {0: 0, 1: 1, 3: 2}[r], "p44 shrink")
    full2 = np.random.default_rng(OSC_SEED + 45).standard_normal(
        (n2, 1 << 14), dtype=np.float32)
    win2 = api.Win_allocate(s, 1 << 14, np.float32, name="p44b",
                            force="shm")
    win2.local[:] = 0.0
    win2.fence()
    win2.put(full2[sr], (sr + 1) % n2)
    win2.fence()
    check(np.array_equal(win2.local, full2[(sr - 1) % n2]), "p44 ring")
    win2.free()
    s.barrier()
    s.free()
    return [f"p44, 4 ranks: rank 2 SIGKILLed in a fence epoch; rank 0 saw "
            f"it failed after {detect_ms:.1f} ms, then ERR_PROC_FAILED "
            f"from fence and from a put to it, revoke, free, shrink to 3 "
            f"and a fenced ring on a new window"]


def _osc_rank(kind: str, report: str) -> int:
    """The rank program of phase 16(c) (``--osc-rank KIND REPORT``, run
    by mpirun --per-rank on cuda:0); rank 0 writes its lines."""
    from ompi_tpu_torch.accelerator import job_tag
    MPI.Init()
    w = MPI.get_comm_world()
    check(w.device.type == "cuda", f"rank on {w.device}")
    out_dir = os.path.dirname(report)
    if kind.startswith("p43"):
        lines = _osc_p43(w, kind[4:], out_dir)
    elif kind == "p13":
        lines = _osc_p13(w)
    else:
        lines = _osc_p44(w)
    if w.rank() == 0:
        with open(report, "w") as fh:
            json.dump({"tag": job_tag(), "lines": lines}, fh)
    r = w.rank()
    MPI.Finalize()
    print(f"OK osc {kind} rank={r}", flush=True)
    return 0


def phase_onesided_job(smi: str, world_s: float) -> None:
    """Phase 16(c): the p43 drill on shm and on pt2pt, p13 and p44 as
    per-rank jobs on cuda:0, and 16(b)'s fresh-process DtoH count, all
    started at once."""
    import glob
    import signal
    import tempfile
    from ompi_tpu_torch.accelerator import SHM_DIR
    from ompi_tpu_torch.osc.shm import WIN_PREFIX
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    mpirun = os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py")
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for kind, n, mca, want_rc in (
                ("p43 shm", 4, (("mpi_base_telemetry", 1),
                                ("mpi_base_telemetry_flightrec_dir", tmp)),
                 0),
                ("p43 pt2pt", 4, (), 0), ("p13", 3, (), 0),
                ("p44", 4, OSC_HB, 256 - signal.SIGKILL)):
            rep = os.path.join(tmp, kind.replace(" ", "_") + ".json")
            cmd = [sys.executable, mpirun, "--per-rank", "-n", str(n),
                   "--timeout", str(OSC_JOB_TIMEOUT)]
            if kind == "p44":
                cmd.append("--enable-recovery")
            for k, v in mca:
                cmd += ["--mca", k, str(v)]
            cmd += [me, "--osc-rank", kind.replace(" ", "_"), rep]
            jobs.append((kind, n - (kind == "p44"), want_rc, rep,
                         subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True,
                                          cwd=root, start_new_session=True)))
        fresh = os.path.join(tmp, "dtoh.json")
        jobs.append(("fresh DtoH check", 0, 0, fresh, subprocess.Popen(
            [sys.executable, me, "--osc-fresh-check", fresh],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=root, start_new_session=True)))
        outs = []
        deadline = time.monotonic() + OSC_JOB_TIMEOUT + 5
        for kind, _n, _rc, _rep, p in jobs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                outs.append(("", f"{kind}: killed at the phase's limit"))
        for *_x, p in jobs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        lines, tags = [], []
        for (kind, n, want_rc, rep, p), (out, err) in zip(jobs, outs):
            oks = out.count("OK osc")
            if p.returncode != want_rc or oks != n:
                sys.stderr.write(err[-6000:])
                check(False, f"{kind}: rc={p.returncode} (want {want_rc}), "
                      f"{oks} of {n} ranks OK:\n{out[-3000:]}")
            with open(rep) as f:
                res = json.load(f)
            if n:
                lines += res["lines"]
                tags.append(res["tag"])
            else:
                check(res["control"] >= 1, f"the profiler saw "
                      f"{res['control']} DtoH events in a .cpu() copy")
                bad = {k: v for k, v in res["counts"].items() if v}
                check(not bad, f"Memcpy DtoH events inside Win {bad}")
                lines.append(f"0 Memcpy DtoH events (torch.profiler, a fresh "
                             f"process) in each of "
                             f"{', '.join(res['counts'])} from a CUDA origin "
                             f"at 32 MB; the control's .cpu() showed "
                             f"{res['control']}")
    left = [f for t in tags
            for f in glob.glob(os.path.join(SHM_DIR, f"otpt*_{t}_*"))]
    check(all(tags) and not left, f"files left: {left}")
    job_s = time.perf_counter() - t0
    for line in lines:
        phase("onesided", f"{line} | {smi}")
    check(world_s + job_s < OSC_JOB_PHASE_S, f"phase 16 took "
          f"{world_s + job_s:.1f} s")
    phase("onesided", f"per-rank jobs rc 0, 0, 0 and {256 - signal.SIGKILL} "
          f"(p44's victim, killed by SIGKILL); no {WIN_PREFIX}_ or other "
          f"otpt*_ file of the four jobs left under {SHM_DIR}; per-rank part "
          f"{job_s:.1f} s; phase 16 took {world_s + job_s:.1f} s (limit "
          f"{OSC_JOB_PHASE_S} s) | {smi}")


# -- phase 17 ------------------------------------------------------------
PLN_SEED = 1700
PLN_HEAP = LOCAL_ELEMS         # 2**23 fp32 per PE: 32 MB, a power of two
PLN_JOB_TIMEOUT = 60           # seconds each per-rank job may take
PLN_PHASE_S = 90               # the whole phase must end within this
PLN_PART = 1 << 21             # a memchecked partition: 8 MB of fp32
PLN_ATOMICS = 200              # fetching atomics timed on the int32 heap


def _dtoh(fn) -> tuple:
    """(count, bytes) of the ``Memcpy DtoH`` records torch.profiler takes
    from the card inside ``fn()``: the count from ``key_averages``, the
    bytes from the memcpy records of its Chrome trace (None when a record
    carries no byte count)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    count = sum(e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "DtoH" in e.key)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    sizes = [e.get("args", {}).get("bytes") for e in events
             if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", "")]
    return count, (None if None in sizes else sum(sizes))


def _dtoh_split(calls: dict) -> dict:
    """{name: (count, bytes)} of the ``Memcpy DtoH`` records each call
    made, all in one torch.profiler session: each call runs, and drains
    the card, inside its own ``record_function`` range, and a memcpy
    record of the Chrome trace counts for the range that holds its
    start."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            with record_function(f"dtoh:{name}"):
                fn()
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    ranges = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"][5:])
              for e in events if e.get("cat") == "user_annotation"
              and str(e.get("name", "")).startswith("dtoh:")]
    check(sorted(n for _a, _b, n in ranges) == sorted(calls),
          f"the profiler's ranges {sorted(n for _a, _b, n in ranges)}")
    out = {name: [0, 0] for name in calls}
    for e in events:
        if e.get("cat") != "gpu_memcpy" or "DtoH" not in e.get("name", ""):
            continue
        owner = [n for a, b, n in ranges if a <= e["ts"] <= b]
        check(len(owner) == 1, f"a DtoH record at {e['ts']} outside the "
                               f"calls' ranges")
        out[owner[0]][0] += 1
        out[owner[0]][1] += int(e.get("args", {}).get("bytes") or 0)
    return {name: tuple(v) for name, v in out.items()}


def _pln_shmem(w, x, xh, smi: str) -> list:
    """17(a): ShmemCtx over the 8 PEs on cuda:0, a 32 MB fp32 heap each
    (256 MB on the card), then the atomics on an int32 heap."""
    from ompi_tpu_torch.shmem import ShmemCtx
    n, dev = w.size, w.device
    ctx = ShmemCtx(w, heap_size=PLN_HEAP, dtype=np.float32)
    buf = ctx.heap.buffer
    check(buf.device == dev and tuple(buf.shape) == (n, PLN_HEAP),
          f"heap {tuple(buf.shape)} on {buf.device}")
    check(ctx._buddy >= 0, "the buddy allocator does not serve the heap")
    a = ctx.malloc(PLN_HEAP)
    check(a == 0, f"malloc of the whole heap at {a}")
    for pe in range(n):
        ctx.put(pe, a, x[pe])            # CUDA origins
    check(all(torch.equal(buf[pe], x[pe]) for pe in range(n)), "put rows")
    put_ms = device_ms(lambda: ctx.put(3, a, x[3]), iters=10, warmup=2)
    t0 = time.perf_counter()
    got = ctx.get(5, a, PLN_HEAP)
    get_ms = (time.perf_counter() - t0) * 1e3
    check(isinstance(got, np.ndarray) and _bits(got, xh[5]), "get")
    lines = [f"(a) ShmemCtx, 8 PEs x 2**23 fp32 (32 MB each, 256 MB heap on "
             f"{dev}, buddy allocator): 32 MB put from a CUDA origin "
             f"{put_ms:.4f} ms device ({_hbm(2 * x[3].nbytes, put_ms)}), "
             f"get {get_ms:.2f} ms host (D2H); rows = numpy bit for bit"]
    check(_bits(ctx.collect(a, PLN_HEAP), xh.reshape(-1)), "collect")
    seg = (1000, PLN_HEAP // 32)       # 1 MB per PE
    check(_bits(ctx.fcollect(a + seg[0], seg[1]),
                xh[:, seg[0]:seg[0] + seg[1]].reshape(-1)), "fcollect")
    ctx.broadcast(a, PLN_HEAP, root_pe=2)
    check(_bits(ctx.collect(a, PLN_HEAP), np.tile(xh[2], n)), "broadcast")
    bc_ms = device_ms(lambda: ctx.broadcast(a, PLN_HEAP, root_pe=2),
                      iters=5, warmup=1)
    times = {"broadcast": bc_ms}
    for name, fold in (("sum_to_all", np.add), ("max_to_all", np.maximum)):
        for pe in range(n):
            ctx.put(pe, a, x[pe])
        getattr(ctx, name)(a, PLN_HEAP)
        want = xh[0].copy()
        for pe in range(1, n):           # the PE-order fold, in float32
            want = fold(want, xh[pe])
        check(_bits(ctx.collect(a, PLN_HEAP), np.tile(want, n)), name)
        times[name] = device_ms(lambda nm=name: getattr(ctx, nm)(
            a, PLN_HEAP), iters=5, warmup=1)
    err = float(np.abs(want - xh.max(axis=0)).max())
    check(err == 0.0, "max_to_all against numpy's max")
    for pe in range(n):
        ctx.put(pe, a, x[pe])
    blk = PLN_HEAP // n
    ctx.alltoall(a, blk)
    want = xh.reshape(n, n, blk).transpose(1, 0, 2).reshape(n, PLN_HEAP)
    check(_bits(ctx.collect(a, PLN_HEAP), want.reshape(-1)), "alltoall")
    times["alltoall"] = device_ms(lambda: ctx.alltoall(a, blk), iters=5,
                                  warmup=1)
    ctx.free(a)
    rows = {"broadcast": n, "sum_to_all": 2 * n, "max_to_all": 2 * n,
            "alltoall": 2 * n}          # least rows read + written
    lines.append("(a) collect, fcollect (1 MB per PE), broadcast, "
                 "sum_to_all, max_to_all (the PE-order float32 fold) and "
                 "alltoall over the heap = numpy bit for bit; device ms "
                 "at 32 MB per PE: " + ", ".join(
                     f"{k} {v:.4f} ({_hbm(rows[k] * PLN_HEAP * 4, v)})"
                     for k, v in times.items()))
    ictx = ShmemCtx(w, heap_size=1 << 10, dtype=np.int32)
    check(ictx.heap.buffer.dtype == torch.int32
          and ictx.heap.buffer.device == dev, "int32 heap")
    cnt, lk, bits = ictx.malloc(1), ictx.malloc(1), ictx.malloc(1)
    t0 = time.perf_counter()
    olds = [int(ictx.atomic_fetch_add(4, cnt, 1))
            for _ in range(PLN_ATOMICS)]
    fa_us = (time.perf_counter() - t0) / PLN_ATOMICS * 1e6
    check(olds == list(range(PLN_ATOMICS))
          and int(ictx.g(4, cnt)) == PLN_ATOMICS, "atomic_fetch_add")
    t0 = time.perf_counter()
    for _ in range(PLN_ATOMICS):
        ictx.g(4, cnt)
    g_us = (time.perf_counter() - t0) / PLN_ATOMICS * 1e6
    check(int(ictx.atomic_compare_swap(4, cnt, PLN_ATOMICS, -7))
          == PLN_ATOMICS and int(ictx.g(4, cnt)) == -7, "compare_swap")
    check(int(ictx.atomic_compare_swap(4, cnt, 0, 9)) == -7
          and int(ictx.g(4, cnt)) == -7, "failing compare_swap")
    ictx.set_lock(lk, pe=3)
    check(not ictx.test_lock(lk, pe=5), "held lock acquired twice")
    try:
        ictx.set_lock(lk, pe=5)
        check(False, "set_lock on a held lock returned")
    except MPI.MPIError as e:
        check(e.error_class == MPI.ERR_PENDING, f"set_lock: {e}")
    ictx.clear_lock(lk, pe=3)
    ictx.set_lock(lk, pe=5)
    ictx.clear_lock(lk, pe=5)
    check(int(ictx.g(0, lk)) == 0, "lock word after the round")
    ictx.p(2, bits, 0b1100)
    ictx.atomic_and(2, bits, 0b1010)
    ictx.atomic_or(2, bits, 0b0001)
    old = int(ictx.atomic_fetch_xor(2, bits, 0b1111))
    check(old == 0b1001 and int(ictx.g(2, bits)) == 0b0110,
          "bitwise atomics")
    lines.append(f"(a) int32 heap on {dev}: {PLN_ATOMICS} atomic_fetch_add "
                 f"in order, compare_swap (and a failing one), a lock round "
                 f"(a held lock raises ERR_PENDING), and/or/fetch_xor = "
                 f"expected; {fa_us:.1f} µs per fetching atomic and "
                 f"{g_us:.1f} µs per g (each reads one element back from "
                 f"the card: host clock)")
    return lines


def _pln_io(w, x, xh) -> list:
    """17(b): a File on the world in a temp dir."""
    import tempfile
    from ompi_tpu_torch.io import File
    n = w.size
    with tempfile.TemporaryDirectory() as tmp:
        df = subprocess.run(["df", "-T", tmp], capture_output=True,
                            text=True, timeout=30, check=True).stdout
        fstype = df.splitlines()[1].split()[1]
        path = os.path.join(tmp, "planes.bin")
        with File(w, path, etype=np.float32) as f:
            t0 = time.perf_counter()
            wrote = f.write_at_all(0, x)
            w_ms = (time.perf_counter() - t0) * 1e3
            check(wrote == n * PLN_HEAP and os.path.getsize(path)
                  == x.numel() * 4, f"write_at_all wrote {wrote}")
            t0 = time.perf_counter()
            back = f.read_at_all(0, PLN_HEAP)
            r_ms = (time.perf_counter() - t0) * 1e3
            check(isinstance(back, np.ndarray) and _bits(back, xh),
                  "read_at_all")
            t = MPI.FLOAT.create_vector(2, 1, 2).create_resized(0, 4).commit()
            f.set_view(0, np.float32, t)
            f.write_at(0, x[1, :8])       # lands on elements 0, 2, ..., 14
            f.set_view(0, np.float32, None)
            want = xh[0, :16].copy()
            want[::2] = xh[1, :8]
            check(_bits(f.read_at(0, 16), want), "strided view write")
            f.set_view(0, MPI.FLOAT, t)
            check(_bits(f.read_at(1, 3), xh[1, 1:4]), "strided view read")
            f.set_view(0, np.float32, None)
            end = n * PLN_HEAP
            f.seek_shared(end)
            f.write_shared(x[2, :1000])
            f.write_shared(x[3, :24])
            check(f.get_position_shared() == end + 1024, "shared pointer")
            f.seek_shared(end)
            check(_bits(f.read_shared(1024), np.concatenate(
                [xh[2, :1000], xh[3, :24]])), "read_shared")
            f.seek_shared(end + 1024)
            f.write_ordered(x[:, :4096])
            check(f.get_position_shared() == end + 1024 + n * 4096,
                  "write_ordered pointer")
            f.seek_shared(end + 1024)
            check(_bits(f.read_ordered(4096), xh[:, :4096]), "read_ordered")
    gb = x.numel() * 4 / 1e9
    return [f"(b) File on the world in a temp dir ({fstype}, df -T): "
            f"write_at_all of the stacked 8 x 32 MB CUDA tensor "
            f"{w_ms:.1f} ms ({gb / w_ms * 1e3:.2f} GB/s: one D2H, the "
            f"two-phase merge and pwrite), read_at_all {r_ms:.1f} ms "
            f"({gb / r_ms * 1e3:.2f} GB/s) = the tensor bit for bit; a "
            f"strided vector view from a CUDA origin, the shared pointer "
            f"and write_ordered/read_ordered of 8 x 4096 = numpy"]


def _pln_checkpoint(w, x) -> list:
    """17(c): entry()'s params in bf16 and the stacked buffer, saved from
    cuda:0 and restored with comm=world."""
    import dataclasses as dc
    import tempfile
    from ompi_tpu_torch.io import checkpoint as ckpt
    _fn, (params, tokens) = entry()
    params = tree_map(lambda t: t.bfloat16(), params)
    dense = dc.replace(CONFIG, use_flash=False)

    def forward(p):                     # bf16 weights, read exactly in fp32
        with torch.no_grad():
            return T.forward(tree_map(lambda t: t.float(), p), tokens,
                             dense)
    launches = FA.launches
    want = forward(params)
    state = {"params": params, "stacked": x, "step": np.int64(17)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        ckpt.save(path, state, step=17)
        s_ms = (time.perf_counter() - t0) * 1e3
        like = {"params": tree_map(torch.empty_like, params),
                "stacked": w.alloc((1,)), "step": np.int64(0)}
        t0 = time.perf_counter()
        got = ckpt.restore(path, like, comm=w)
        torch.cuda.synchronize()
        r_ms = (time.perf_counter() - t0) * 1e3
        check(ckpt.latest_step(path) == 17, "latest_step")
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
    pl, gl = tree_leaves(params), tree_leaves(got["params"])
    check(len(pl) == len(gl) and all(
        g.dtype == torch.bfloat16 and g.device == w.device
        and torch.equal(g.view(torch.int16), p.view(torch.int16))
        for p, g in zip(pl, gl)), "bf16 params bit for bit on the card")
    st = got["stacked"]
    check(st.device == w.device and st.dtype == torch.float32
          and torch.equal(st.view(torch.int32), x.view(torch.int32)),
          "stacked leaf bit for bit on the card")
    check(int(got["step"]) == 17, "step leaf")
    logits = forward(got["params"])
    check(logits.dtype == want.dtype and torch.equal(
        logits.view(torch.int32), want.view(torch.int32))
        and bool(torch.isfinite(logits).all()), "logits after restore")
    check(FA.launches == launches, "the checkpoint forward launched")
    return [f"(c) checkpoint of entry()'s {len(pl)} params in bf16 "
            f"({sum(t.numel() for t in pl)} values) and the 8 x 32 MB "
            f"stacked buffer from {w.device}: {nbytes / 1e6:.1f} MB on disk, "
            f"save {s_ms:.1f} ms, restore with comm=world {r_ms:.1f} ms "
            f"(host clock); every leaf bit for bit, bf16 kept, the stacked "
            f"leaf and the params on {w.device}; the dense forward's "
            f"{tuple(logits.shape)} {logits.dtype} logits from the restored "
            f"params bit for bit (no kernel launch)"]


def _pln_memchecker(w) -> list:
    """17(d): the memchecker on, partitioned sends of CUDA partitions."""
    from ompi_tpu_torch.utils import memchecker as mc
    dev = w.device
    g = torch.Generator(device=dev).manual_seed(PLN_SEED + 4)
    var.var_set("mpi_memchecker_enable", True)
    mc._reset_for_tests()
    try:
        parts = list(torch.randn((4, PLN_PART), device=dev, generator=g))
        keep = [p.clone() for p in parts]
        out = []
        for dirty in (False, True):
            req = w.psend_init(parts, dest=6, tag=17, src=1)
            rreq = w.precv_init(1, tag=17, partitions=4, dst=6)
            rreq.start()
            req.start()
            req.pready_range(0, 2)
            if dirty:
                parts[1][5] = -1.0       # after pready: the misuse
                try:
                    req.pready(3)
                    check(False, "no MemcheckError for a dirty partition")
                except mc.MemcheckError as e:
                    check("partition 1" in str(e), f"memchecker: {e}")
            else:
                t0 = time.perf_counter()
                req.pready(3)
                v_ms = (time.perf_counter() - t0) * 1e3
            rreq.wait()
            got = rreq.get()
            check(all(t.device == dev and torch.equal(t, k)
                      for t, k in zip(got, keep)), "partitions delivered")
            out.append(len(mc._tracked))
        check(out == [0, 0] and mc.violations() == 1,
              f"tracked {out}, violations {mc.violations()}")
    finally:
        var.var_set("mpi_memchecker_enable", False)
        mc._reset_for_tests()
    return [f"(d) memchecker on: a partitioned send of 4 x 8 MB CUDA "
            f"partitions (clones on {dev} at pready) completes clean, the "
            f"last pready with its 4 verifications {v_ms:.2f} ms host; a "
            f"write to partition 1 after pready raises MemcheckError at "
            f"completion, every entry released, the payload delivered as "
            f"sent"]


def _pln_mpiext_tool(w) -> list:
    """17(e): the mpiext modules and MPI_T on the card."""
    from ompi_tpu_torch.api import tool
    from ompi_tpu_torch.mpiext import accel, affinity, shortfloat
    n, dev = w.size, w.device
    check(accel.Query_cuda_support() is True
          and accel.Query_tpu_support() is False, "accel queries")
    inv = accel.Device_inventory()
    check(len(inv) == torch.cuda.device_count() and inv[0]["kind"]
          == torch.cuda.get_device_name(0) and inv[0]["platform"] == "gpu",
          f"inventory {inv}")
    g = torch.Generator(device=dev).manual_seed(PLN_SEED + 5)
    u = torch.rand((n, 2 * LOCAL_ELEMS), device=dev, generator=g) + 0.5
    lines = []
    for dt, alias in ((torch.float16, shortfloat.SHORT_FLOAT),
                      (torch.bfloat16, shortfloat.C_BF16)):
        check(alias.base is dt, f"{alias} base")
        xs = u.to(dt)                   # 32 MB per rank
        y = w.allreduce(xs, MPI.SUM)
        check(y.dtype == dt and y.device == dev, f"{dt} result on {y.device}")
        want = xs.double().sum(0).cpu().numpy()
        got = y[0].double().cpu().numpy()
        check(all(torch.equal(y[r], y[0]) for r in range(n)), "rows agree")
        np.testing.assert_allclose(got, want, rtol=2e-2)
        rel = float((np.abs(got - want) / np.abs(want)).max())
        ms = device_ms(lambda: w.allreduce(xs, MPI.SUM), iters=10)
        lines.append(f"(e) {alias.name} allreduce SUM, 8 x 32 MB on {dev}: "
                     f"= float64 numpy (rtol 2e-2; worst {rel:.2e}), rows "
                     f"identical, {ms:.4f} ms device")
    amap = affinity.Affinity_map(w)
    check(all(f"rank {r} bound to cuda:0 " in s for r, s in enumerate(amap)),
          f"affinity {amap}")
    table = tool.decision_table(n)
    check(decision.platform_key(dev) == "gpu" and table ==
          tool.decision_table(n, platform="gpu"), "decision rows")
    old = tool.cvar_read("coll_base_verbose")
    tool.cvar_write("coll_base_verbose", 9)
    check(tool.cvar_read("coll_base_verbose") == 9, "cvar write")
    tool.cvar_write("coll_base_verbose", old)
    lines.append(f"(e) Query_cuda_support True, Query_tpu_support False, "
                 f"Device_inventory {inv[0]['kind']!r}; Affinity_str "
                 f"{affinity.Affinity_str(w, 3)[0]!r}; decision_table(8) "
                 f"reads the \"gpu\" rows (allreduce {table['allreduce']}); "
                 f"a cvar write read back")
    return lines


def phase_planes_world(w, smi: str) -> float:
    """Phase 17 (a)-(e) on the live 8-rank world on cuda:0."""
    t0 = time.perf_counter()
    g = torch.Generator(device=w.device).manual_seed(PLN_SEED)
    x = torch.randn((w.size, PLN_HEAP), device=w.device, generator=g)
    xh = x.cpu().numpy()
    lines = (_pln_shmem(w, x, xh, smi) + _pln_io(w, x, xh)
             + _pln_checkpoint(w, x) + _pln_memchecker(w)
             + _pln_mpiext_tool(w))
    del x, xh
    torch.cuda.empty_cache()
    for line in lines:
        phase("planes", f"{line} | {smi}")
    return time.perf_counter() - t0


def _pln_fresh_check(report: str) -> int:
    """17's DtoH counts in a process of their own
    (``--planes-fresh-check``; see ``_fresh_check``): shmem calls from a
    CUDA origin and over the heap, and the memchecker's marks on CUDA
    tensors, each warmed once, then counted under the profiler, with a
    ``.cpu()`` control."""
    from ompi_tpu_torch.shmem import ShmemCtx
    from ompi_tpu_torch.utils import memchecker as mc
    dev = torch.device("cuda", 0)
    MPI.Init(devices=[dev] * N_RANKS)
    w = MPI.get_comm_world()
    ctx = ShmemCtx(w, heap_size=PLN_HEAP, dtype=np.float32)
    a = ctx.malloc(PLN_HEAP)
    x = torch.randn((2, PLN_HEAP), device=dev)
    calls = {"put": lambda: ctx.put(3, a, x[0]),
             "put_nbi": lambda: ctx.put_nbi(4, a, x[1]),
             "iput": lambda: ctx.iput(2, a, x[1, :1 << 20], tst=2),
             "broadcast": lambda: ctx.broadcast(a, PLN_HEAP, 3),
             "sum_to_all": lambda: ctx.sum_to_all(a, PLN_HEAP),
             "max_to_all": lambda: ctx.max_to_all(a, PLN_HEAP),
             "alltoall": lambda: ctx.alltoall(a, PLN_HEAP // N_RANKS)}
    var.var_set("mpi_memchecker_enable", True)
    parts = list(torch.randn((4, PLN_PART), device=dev))
    marks = {"inflight x4": lambda: [mc.inflight(p) for p in parts],
             "verify x4": lambda: [mc.verify(p) for p in parts]}
    rep = {"counts": {}, "marks": {}}
    for name, fn in calls.items():
        fn()
        rep["counts"][name] = _dtoh(fn)
    for _ in range(2):                  # warm, then count
        for name, fn in marks.items():
            rep["marks"][name] = _dtoh(fn)
    t = torch.ones(1024, device=dev)
    rep["control"] = _dtoh(lambda: t.cpu())
    with open(report, "w") as fh:
        json.dump(rep, fh)
    var.var_set("mpi_memchecker_enable", False)
    MPI.Finalize()
    return 0


def _planes_rank(report: str) -> int:
    """The 4-rank RankFile job of 17(f) (``--planes-rank REPORT``, run by
    mpirun --per-rank on cuda:0): 32 MB per rank from a CUDA tensor,
    written collectively, every peer's block read back; rank 0 writes
    its lines."""
    from ompi_tpu_torch.accelerator import job_tag
    from ompi_tpu_torch.io.perrank import RankFile
    MPI.Init()
    w = MPI.get_comm_world()
    r, n = w.rank(), w.size
    check(w.device.type == "cuda", f"rank on {w.device}")
    g = torch.Generator(device=w.device).manual_seed(PLN_SEED + 21)
    full = torch.randn((n, PLN_HEAP), device=w.device, generator=g)
    fullh = full.cpu().numpy()
    path = report + ".dat"
    with RankFile(w, path, etype=np.float32) as f:
        w.barrier()
        t0 = time.perf_counter()
        f.write_at_all(r * PLN_HEAP, full[r])
        w_ms = (time.perf_counter() - t0) * 1e3
        f.sync()
        for peer in range(n):
            check(_bits(f.read_at(peer * PLN_HEAP, PLN_HEAP), fullh[peer]),
                  f"rank {r} read of block {peer}")
        w.barrier()
        t0 = time.perf_counter()
        mine = f.read_at_all(r * PLN_HEAP, PLN_HEAP)
        r_ms = (time.perf_counter() - t0) * 1e3
        check(_bits(mine, fullh[r]), "read_at_all")
        check(f.get_size() == n * PLN_HEAP * 4, "file size")
    w.barrier()
    if r == 0:
        os.unlink(path)
        with open(report, "w") as fh:
            json.dump({"tag": job_tag(), "lines": [
                f"RankFile, 4 ranks on cuda:0: write_at_all of 32 MB per "
                f"rank from a CUDA tensor (staged with .cpu(), gathered to "
                f"the aggregator) {w_ms:.1f} ms on rank 0, every peer's "
                f"block read back bit for bit on every rank, read_at_all "
                f"{r_ms:.1f} ms (host clock)"]}, fh)
    MPI.Finalize()
    print(f"OK planes rank={r}", flush=True)
    return 0


def phase_planes_job(smi: str, world_s: float) -> None:
    """Phase 17(f): the port's p14, p20 and p21 on 3 ranks, the 4-rank
    RankFile job and the fresh process's DtoH counts, all started at
    once."""
    import glob
    import importlib.util
    import signal
    import tempfile
    import textwrap
    from ompi_tpu_torch.accelerator import SHM_DIR
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    mpirun = os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py")
    me = os.path.abspath(__file__)
    spec = importlib.util.spec_from_file_location(
        "planes_programs", os.path.join(root, "tests",
                                        "test_torch_planes_perrank.py"))
    progs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(progs)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for kind, n, body in (("p14", 3, progs.P14), ("p20", 3, progs.P20),
                              ("p21", 3, progs.P21), ("rankfile", 4, None)):
            out = os.path.join(tmp, kind)
            cmd = [sys.executable, mpirun, "--per-rank", "-n", str(n),
                   "--timeout", str(PLN_JOB_TIMEOUT)]
            if body is None:
                cmd += [me, "--planes-rank", out + ".json"]
            else:
                prog = out + ".py"
                with open(prog, "w") as fh:
                    fh.write(progs.HEADER + textwrap.dedent(body))
                cmd += [prog, out + ".dat"]
            jobs.append((kind, n, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=root, start_new_session=True)))
        fresh = os.path.join(tmp, "dtoh.json")
        jobs.append(("fresh DtoH check", 0, fresh, subprocess.Popen(
            [sys.executable, me, "--planes-fresh-check", fresh],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=root, start_new_session=True)))
        outs = []
        deadline = time.monotonic() + PLN_JOB_TIMEOUT + 5
        for kind, _n, _out, p in jobs:
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                outs.append(("", f"{kind}: killed at the phase's limit"))
        for *_x, p in jobs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        lines, tags = [], []
        for (kind, n, out, p), (so, se) in zip(jobs, outs):
            marker = "OK planes" if kind == "rankfile" else f"OK {kind}_"
            if p.returncode != 0 or so.count(marker) != n:
                sys.stderr.write(se[-6000:])
                check(False, f"{kind}: rc={p.returncode}, "
                      f"{so.count(marker)} of {n} ranks OK:\n{so[-3000:]}")
            if kind == "rankfile":
                with open(out + ".json") as f:
                    res = json.load(f)
                lines += res["lines"]
                tags.append(res["tag"])
            elif n:
                tags += [ln.split()[1] for ln in so.splitlines()
                         if ln.startswith("TAG ")]
                check(not os.path.exists(out + ".dat"), f"{kind} file left")
            else:
                with open(out) as f:
                    res = json.load(f)
                ccount, cbytes = res["control"]
                check(ccount >= 1, f"the profiler saw {ccount} DtoH events "
                      f"in a .cpu() copy")
                bad = {k: v for k, v in res["counts"].items() if v[0]}
                check(not bad, f"Memcpy DtoH events in shmem calls {bad}")
                inf_n, inf_b = res["marks"]["inflight x4"]
                ver_n, ver_b = res["marks"]["verify x4"]
                check(inf_n == 0, f"{inf_n} DtoH events in inflight")
                check(ver_n <= 4 if ver_b is None else ver_b <= 4 * 8,
                      f"verify read back {ver_n} records, {ver_b} bytes")
                lines.append(
                    f"0 Memcpy DtoH events (torch.profiler, a fresh process) "
                    f"in each of {', '.join(res['counts'])} on the 32 MB "
                    f"heap from CUDA origins; memchecker marks of 4 x 8 MB "
                    f"CUDA partitions: inflight {inf_n} DtoH, verify "
                    f"{ver_n} DtoH of {ver_b} bytes in all (one scalar per "
                    f"torch.equal, no payload); the control's .cpu() of "
                    f"4096 bytes showed {ccount} record(s) of {cbytes} bytes")
    check(len(tags) == 4 and all(tags), f"job tags {tags}")
    left = [f for t in tags
            for f in glob.glob(os.path.join(SHM_DIR, f"otpt*_{t}_*"))]
    check(not left, f"files left: {left}")
    job_s = time.perf_counter() - t0
    for line in lines:
        phase("planes", f"{line} | {smi}")
    check(world_s + job_s < PLN_PHASE_S, f"phase 17 took "
          f"{world_s + job_s:.1f} s")
    phase("planes", f"(f) p14, p20 and p21 on 3 ranks and the RankFile job "
          f"on 4, all on cuda:0 with CUDA origins: every rank OK, rc 0; no "
          f"otpt*_ file of the four jobs left under {SHM_DIR}; per-rank "
          f"part {job_s:.1f} s; phase 17 took {world_s + job_s:.1f} s "
          f"(limit {PLN_PHASE_S} s) | {smi}")


# -- phase 18 ----------------------------------------------------------
TLS_SEED = 1800
TLS_CALLS = 3                  # calls of each collective on the traced dup
TLS_COLLS = ("allreduce", "bcast", "allgather")
# fp32 elements of the CUDA sends (4 KB, 4 MB, 32 MB): below and above
# devxfer's 1 MiB switch, and one rank's full width
TLS_SENDS = (1 << 10, 1 << 20, LOCAL_ELEMS)
TLS_MSGS = 20                  # messages per rank in the witness ring
TLS_JOB_TIMEOUT = 60           # seconds each per-rank job may take
TLS_PHASE_S = 90               # the whole phase must end within this


def _tls_traffic(w, x, elems: int) -> tuple:
    """On a dup of ``w`` built with tracing, telemetry and monitoring on:
    TLS_CALLS of each collective at ``elems`` fp32 per rank, held
    against the plain world; CUDA sends of TLS_SENDS sizes (capped at
    ``elems``) around the ring; an ``irecv`` posted for a CUDA payload.
    PERUSE counts the sends. Returns (dup, calls, sent bytes matrix,
    peruse handle, fired list, posted request)."""
    from ompi_tpu_torch import telemetry, trace
    from ompi_tpu_torch.coll import monitoring
    from ompi_tpu_torch.tools import peruse
    n = w.size
    trace.enable()
    trace.reset()
    telemetry.enable()
    monitoring.reset()
    d = _dup_with(w, coll_monitoring_enable=True)
    fired = []
    h = peruse.Event_comm_register(
        "PERUSE_COMM_REQ_XFER_BEGIN", d,
        lambda ev, comm, info: fired.append(ev))
    h.start()
    want = w.allreduce(x, MPI.SUM)
    for _ in range(TLS_CALLS):
        check(torch.equal(d.allreduce(x, MPI.SUM), want),
              "traced allreduce differs from the plain world's")
        b = d.bcast(x, 3)
        check(torch.equal(b, x[3].expand_as(b)), "traced bcast")
        a = d.allgather(x)
        check(torch.equal(a[0].reshape(x.shape), x)
              and torch.equal(a, a[0].expand_as(a)), "traced allgather")
        del a, b
    del want
    sent = np.zeros((n, n), np.int64)
    for i, k in enumerate(TLS_SENDS):
        k = min(k, elems)
        src, dst = i % n, (i + 1) % n
        t = x[src, :k]
        d.send(t, src=src, dest=dst, tag=180 + i)
        got, st = d.recv(source=src, tag=180 + i, dst=dst)
        check(got.device == x.device and torch.equal(got, t)
              and st.source == src, f"CUDA send of {k} fp32")
        sent[src, dst] += k * 4
    req = d.irecv(source=2, tag=187, dst=5)
    return d, len(TLS_COLLS) * TLS_CALLS, sent, h, fired, req


def _tls_tools(d, calls: int, sent, fired, req, x, dump_dir: str) -> list:
    """The tools over the traffic of ``_tls_traffic``: each checked
    against what was done, each call timed on the host clock."""
    from ompi_tpu_torch import telemetry, trace
    from ompi_tpu_torch.tools import (comm_method, debuggers, info,
                                      mpisync, mpitop, profile, tracedump)
    n, cid = d.size, str(d.cid)
    ms = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    q = timed("message_queues", lambda: debuggers.message_queues(d, dst=5))
    check([p["tag"] for p in q["posted"]] == [187] and not q["unexpected"],
          f"message_queues {q}")
    t = x[2, :1 << 20]
    d.send(t, src=2, dest=5, tag=187)
    req.wait()
    got = req.get()
    check(got.device == x.device and torch.equal(got, t),
          "the posted irecv's CUDA payload")
    sent[2, 5] += t.numel() * 4
    sends = len(TLS_SENDS) + 1
    check(len(fired) == sends, f"PERUSE fired {len(fired)} times for "
          f"{sends} CUDA sends")
    torch.cuda.synchronize()
    tele_path = telemetry.dump(os.path.join(dump_dir, "telemetry_0.json"),
                               rank=0)
    snaps, skipped = timed("mpitop load", lambda: mpitop.load_snapshots(
        [tele_path]))
    summ = timed("mpitop summarize", lambda: mpitop.summarize(
        snaps, per_comm=True))
    timed("mpitop table", lambda: mpitop.render_table(summ))
    rows = [r for r in summ["rows"] if r.get("comm") == cid]
    check(not skipped and len(rows) == 1 and rows[0]["coll_ops"] == calls,
          f"mpitop rows of comm {cid}: {rows}, want {calls} ops")
    tr_path = trace.dump(os.path.join(dump_dir, "trace_0.json"))
    out = os.path.join(dump_dir, "perfetto.json")
    check(timed("tracedump perfetto", lambda: tracedump.main(
        [tr_path, "-o", out])) == 0, "tracedump perfetto")
    with open(out) as f:
        evs = json.load(f)["traceEvents"]
    mine = [s for s in trace.span_dicts() if s.get("cid") == cid]
    per = {f: sum(1 for s in mine if s["name"] == f"coll_{f}")
           for f in TLS_COLLS}
    check(per == dict.fromkeys(TLS_COLLS, TLS_CALLS),
          f"spans per collective {per}")
    check(len([e for e in evs if e.get("ph") == "X"])
          >= len(TLS_COLLS) * TLS_CALLS, "perfetto events")
    summary = os.path.join(dump_dir, "summary.json")
    check(timed("tracedump summary", lambda: tracedump.main(
        [tr_path, "--format", "summary", "-o", summary])) == 0,
          "tracedump summary")
    mat = timed("pt2pt_matrix", lambda: profile.pt2pt_matrix(d, "bytes"))
    check(np.array_equal(mat, sent), f"pt2pt bytes {mat.tolist()} "
          f"against {sent.tolist()}")
    table = timed("coll_table", profile.coll_table)
    got_calls = {f: table.get((d.cid, f), (0, 0))[0] for f in TLS_COLLS}
    check(got_calls == dict.fromkeys(TLS_COLLS, TLS_CALLS),
          f"coll_table calls {got_calls}")
    cm = timed("comm_method", lambda: comm_method.table(d))
    check(cm["platform"] == "gpu" and cm["coll"] == d._coll_winners
          and cm["data_plane"] == "torch/cuda"
          and cm["devices"] == ["cuda:0"] * n, f"comm_method {cm}")
    inf = timed("info", info.collect)
    check("cuda:0" in inf["platform"]
          and inf["native_convertor"] == MPI.native.native_available(),
          f"info {inf['platform']} {inf['native_convertor']}")
    pt = timed("proctable", lambda: debuggers.proctable(d))
    check(len(pt) == n and all(e["device"] == "cuda:0" for e in pt),
          f"proctable {pt}")
    rows = timed("mpisync", lambda: mpisync.sync_report(d, rounds=2))
    check(all(r["offset_s"] == 0.0 for r in rows), "mpisync controller")
    return [
        f"(a) traced dup (trace, telemetry, monitoring on), {TLS_CALLS} x "
        f"{'/'.join(TLS_COLLS)} at {x.shape[1] * 4 >> 20} MB per rank = "
        f"the plain world; mpitop coll_ops {calls} on comm {cid}, "
        f"tracedump {TLS_CALLS} spans per collective and a Perfetto JSON "
        f"of {len(evs)} events that parses; pt2pt_matrix = the "
        f"{int(sent.sum())} bytes of {sends} CUDA sends, coll_table "
        f"{TLS_CALLS} calls per collective; comm_method platform "
        f"{cm['platform']}, data plane {cm['data_plane']}, winners = the "
        f"framework's; info lists {', '.join(inf['platform'])} and native "
        f"{inf['native_convertor']}; proctable {len(pt)} x cuda:0; "
        f"message_queues showed the posted irecv (tag 187) that took a "
        f"CUDA payload; PERUSE fired {len(fired)} times for {sends} CUDA "
        f"sends",
        "(a) tool call ms (host clock): " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items())]


def _tls_lint() -> str:
    from ompi_tpu_torch.analyze import mpilint
    t0 = time.perf_counter()
    rep = mpilint.run_lint()
    lint_ms = (time.perf_counter() - t0) * 1e3
    check(rep["ok"] and not rep["findings"] and not rep["stale_baseline"],
          f"mpilint: {rep['findings']} stale {rep['stale_baseline']}")
    return (f"(c) mpilint over ompi_tpu_torch/: {rep['files']} files, "
            f"{len(rep['rules'])} rules, 0 unbaselined findings, "
            f"{len(rep['suppressed'])} baselined, 0 stale; {lint_ms:.0f} ms")


def _tls_fresh_result(p, report: str) -> str:
    """Wait for the fresh DtoH process and check its counts."""
    import signal
    try:
        _so, se = p.communicate(timeout=TLS_JOB_TIMEOUT)
    except subprocess.TimeoutExpired:
        se = "fresh DtoH check: killed at its limit"
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    if p.returncode != 0:
        sys.stderr.write(se[-6000:])
        check(False, f"fresh DtoH check: rc={p.returncode}")
    with open(report) as f:
        res = json.load(f)
    ccount, cbytes = res["control"]
    check(ccount >= 1, f"the profiler saw {ccount} DtoH events in a .cpu()")
    bad = {k: v for k, v in res["counts"].items() if v[0]}
    check(not bad, f"Memcpy DtoH events in tool calls {bad}")
    return (f"(a) 0 Memcpy DtoH events (torch.profiler, a fresh process) "
            f"in each of {', '.join(res['counts'])} over a traced dup on "
            f"cuda:0; the control's .cpu() of 4096 bytes showed {ccount} "
            f"record(s) of {cbytes} bytes")


def phase_tools_world(w, smi: str) -> float:
    """Phase 18 (a) on the live 8-rank world on cuda:0, with the fresh
    process's DtoH count beside it, and (c)."""
    import signal
    import tempfile
    from ompi_tpu_torch import telemetry, trace
    from ompi_tpu_torch.coll import monitoring
    t0 = time.perf_counter()
    me = os.path.abspath(__file__)
    tmp = tempfile.TemporaryDirectory()
    fresh = os.path.join(tmp.name, "dtoh.json")
    proc = subprocess.Popen(
        [sys.executable, me, "--tools-fresh-check", fresh],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(me), start_new_session=True)
    try:
        g = torch.Generator(device=w.device).manual_seed(TLS_SEED)
        x = torch.randn((w.size, LOCAL_ELEMS), device=w.device,
                        generator=g)
        d, calls, sent, h, fired, req = _tls_traffic(w, x, LOCAL_ELEMS)
        try:
            lines = _tls_tools(d, calls, sent, fired, req, x, tmp.name)
        finally:
            h.free()
            d.free()
            trace.disable()
            trace.reset()
            telemetry.disable()
            monitoring.reset()
        del x
        torch.cuda.empty_cache()
        lines.append(_tls_lint())
        lines.append(_tls_fresh_result(proc, fresh))
    finally:
        if proc.poll() is None:          # a check above failed first
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        tmp.cleanup()
    for line in lines:
        phase("tools", f"{line} | {smi}")
    return time.perf_counter() - t0


def _tls_fresh_check(report: str) -> int:
    """18(a)'s DtoH count in a process of its own
    (``--tools-fresh-check``; see ``_fresh_check``): the traffic of
    ``_tls_traffic`` at 1 MB per rank, then each tool call warmed once
    and counted under torch.profiler, with a ``.cpu()`` control."""
    import tempfile
    from ompi_tpu_torch import telemetry, trace
    from ompi_tpu_torch.tools import (comm_method, debuggers, info,
                                      mpisync, mpitop, profile, tracedump)
    dev = torch.device("cuda", 0)
    MPI.Init(devices=[dev] * N_RANKS)
    w = MPI.get_comm_world()
    x = torch.randn((w.size, 1 << 18), device=dev)
    d, _calls, _sent, h, _fired, req = _tls_traffic(w, x, 1 << 18)
    rep = {"counts": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tele = telemetry.dump(os.path.join(tmp, "t.json"), rank=0)
        tr = trace.dump(os.path.join(tmp, "tr.json"))
        calls = {
            "mpitop": lambda: mpitop.render_table(mpitop.summarize(
                mpitop.load_snapshots([tele])[0], per_comm=True)),
            "tracedump": lambda: tracedump.main(
                [tr, "--format", "summary", "-o",
                 os.path.join(tmp, "s.json")]),
            "pt2pt_matrix": lambda: profile.pt2pt_matrix(d, "bytes"),
            "coll_table": profile.coll_table,
            "comm_method": lambda: comm_method.table(d),
            "info": info.collect,
            "proctable": lambda: debuggers.proctable(d),
            "message_queues": lambda: debuggers.message_queues(d),
            "mpisync": lambda: mpisync.sync_report(d, rounds=2),
        }
        for name, fn in calls.items():
            fn()
            rep["counts"][name] = _dtoh(fn)
    t = torch.ones(1024, device=dev)
    rep["control"] = _dtoh(lambda: t.cpu())
    d.send(x[2, :4], src=2, dest=5, tag=187)
    req.wait()
    h.free()
    d.free()
    with open(report, "w") as fh:
        json.dump(rep, fh)
    MPI.Finalize()
    return 0


def _tools_rank(mode: str, report: str) -> int:
    """A rank of phase 18(b)'s 8-rank jobs on cuda:0 (``--tools-rank
    MODE REPORT``). ``witness``: the port's p40 under
    ``mpi_base_lockwitness=1`` — a pt2pt ring on a worker thread whose
    even messages are 4 MB CUDA tensors over devxfer, a persistent
    allreduce re-armed on the main thread, ft heartbeats ticking — the
    acquisition graph acyclic and dumped. ``plain``: mpisync's ping-pong
    table and comm_method's transport rows. Both time the 8 B allreduce."""
    import threading
    from ompi_tpu_torch.accelerator import job_tag
    from ompi_tpu_torch.analyze import lockwitness
    from ompi_tpu_torch.runtime.init import _state
    from ompi_tpu_torch.tools import comm_method, mpisync
    MPI.Init(MPI.THREAD_MULTIPLE)
    w = MPI.get_comm_world()
    r, n, dev = w.rank(), w.size, w.device
    check(dev.type == "cuda", f"rank on {dev}")
    check(lockwitness.installed == (mode == "witness"),
          f"witness installed {lockwitness.installed} in mode {mode}")
    out = {"tag": job_tag(), "lines": []}
    if mode == "witness":
        errors = []
        outer, inner = threading.Lock(), threading.Lock()
        big = torch.arange(1 << 20, device=dev, dtype=torch.float32)

        def ring():
            try:
                right, left = (r + 1) % n, (r - 1) % n
                for i in range(TLS_MSGS):
                    msg = (big + (r * 1000 + i)) if i % 2 == 0 \
                        else np.full(256, r * 1000 + i, np.int64)
                    with outer:
                        with inner:
                            pass
                    if r % 2 == 0:
                        w.send(msg, right, tag=40)
                        data, _ = w.recv(left, tag=40)
                    else:
                        data, _ = w.recv(left, tag=40)
                        w.send(msg, right, tag=40)
                    if i % 2 == 0:
                        check(data.device == dev and torch.equal(
                            data, big + (left * 1000 + i)), "CUDA ring")
                    else:
                        check(int(data[0]) == left * 1000 + i, "host ring")
            except BaseException as e:   # noqa: BLE001
                errors.append(e)

        th = threading.Thread(target=ring)
        th.start()
        data = np.full(512, float(r + 1), np.float32)
        ref = np.asarray(w.allreduce(data, MPI.SUM))
        req = w.allreduce_init(data, MPI.SUM)
        for _ in range(10):
            req.start()
            req.wait()
        check(np.asarray(req.get()).tobytes() == ref.tobytes(),
              "persistent plan")
        th.join(timeout=TLS_JOB_TIMEOUT)
        check(not th.is_alive() and not errors, f"ring: {errors}")
        xfer = _state["router"].xfer.stats["sent"]
        check(xfer >= TLS_MSGS // 2, f"devxfer sent {xfer}")
        w.barrier()
        rep = lockwitness.report()
        check(rep["installed"] and rep["edges"] and rep["cycles"] == [],
              f"witness: {len(rep['edges'])} edges, cycles "
              f"{rep['cycles']}")
        lockwitness.dump(f"{report}.lw_r{r}.json", rank=r)
        out["lines"].append(
            f"rank 0: {len(rep['sites'])} witnessed sites, "
            f"{len(rep['edges'])} edges, 0 cycles, max hold "
            f"{rep['max_hold_us']:.1f} us; devxfer carried {xfer} CUDA "
            f"messages of 4 MB")
    else:
        rows = mpisync.sync_report_perrank(w, rounds=10)
        check(len(rows) == n and rows[0]["offset_s"] == 0.0, "mpisync")
        for row in rows[1:]:
            check(abs(row["offset_s"]) <= row["rtt_s"], f"mpisync {row}")
        out["rtt_us"] = [row["rtt_s"] * 1e6 for row in rows[1:]]
        out["offset_us"] = [row["offset_s"] * 1e6 for row in rows[1:]]
        w.send(np.arange(4.0), (r + 1) % n, tag=3)
        w.recv((r - 1) % n, tag=3)
        t = comm_method.table(w)
        check(t["platform"] == "gpu" and t["data_plane"] == "torch/cuda"
              and t["devices"] == ["cuda:0"], f"comm_method {t}")
        out["lines"].append(
            f"rank 0: comm_method platform {t['platform']}, pt2pt "
            f"transports {t['pt2pt_transports']}, btl_sm {t['btl_sm']}")
    small = np.ones(2, np.float32)
    w.barrier()
    out["us_8b"] = _us_per_call(lambda: w.allreduce(small, MPI.SUM),
                                calls=1000, warmup=100)
    w.barrier()
    if r == 0:
        with open(report, "w") as fh:
            json.dump(out, fh)
    MPI.Finalize()
    print(f"OK tools rank={r}/{n} mode={mode}", flush=True)
    return 0


def _tls_job(me, mpirun, root, mode, out, mca) -> tuple:
    import signal
    cmd = [sys.executable, mpirun, "--per-rank", "-n", str(N_RANKS),
           "--timeout", str(TLS_JOB_TIMEOUT)]
    for k, v in mca:
        cmd += ["--mca", k, str(v)]
    cmd += [me, "--tools-rank", mode, out]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=root, start_new_session=True)
    try:
        so, se = p.communicate(timeout=TLS_JOB_TIMEOUT + 5)
    except subprocess.TimeoutExpired:
        so, se = "", f"{mode}: killed at the job's limit"
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    job_s = time.perf_counter() - t0
    marker = "OK tools rank="
    if p.returncode != 0 or so.count(marker) != N_RANKS:
        sys.stderr.write(se[-6000:])
        check(False, f"{mode} job: rc={p.returncode}, {so.count(marker)} "
              f"of {N_RANKS} ranks OK:\n{so[-3000:]}")
    check(job_s < TLS_JOB_TIMEOUT, f"{mode} job took {job_s:.1f} s")
    with open(out) as f:
        return json.load(f), job_s


def phase_tools_job(smi: str, world_s: float) -> None:
    """Phase 18(b): the witness job and the plain job on 8 ranks of
    cuda:0, one after the other (their 8 B allreduce times are compared),
    and the merge of the witness dumps through tracedump."""
    import glob
    import tempfile
    from ompi_tpu_torch.accelerator import SHM_DIR
    from ompi_tpu_torch.tools import tracedump
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    mpirun = os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py")
    me = os.path.abspath(__file__)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        wit, wit_s = _tls_job(me, mpirun, root, "witness",
                              os.path.join(tmp, "witness.json"),
                              (("mpi_base_lockwitness", 1),
                               ("mpi_base_ft_hb_period", 0.05)))
        plain, plain_s = _tls_job(me, mpirun, root, "plain",
                                  os.path.join(tmp, "plain.json"), ())
        dumps = sorted(glob.glob(os.path.join(tmp, "witness.json.lw_r*")))
        check(len(dumps) == N_RANKS, f"witness dumps {dumps}")
        summary = os.path.join(tmp, "summary.json")
        check(tracedump.main(["--format", "summary", "-o", summary,
                              *dumps]) == 0, "tracedump of the dumps")
        with open(summary) as f:
            lw = json.load(f)["lockwitness"]
        check(lw["ranks"] == N_RANKS and lw["edges"] and lw["cycles"] == []
              and lw["per_rank_cycles"] == {}, f"merged witness {lw}")
    left = [f for t in (wit["tag"], plain["tag"])
            for f in glob.glob(os.path.join(SHM_DIR, f"otpt*_{t}_*"))]
    check(not left, f"files left: {left}")
    rtt = plain["rtt_us"]
    lines += plain["lines"] + wit["lines"]
    lines.append(
        f"(b) mpisync.sync_report_perrank on {N_RANKS} ranks: rtt us "
        f"{', '.join(f'{v:.1f}' for v in rtt)} (min {min(rtt):.1f}, max "
        f"{max(rtt):.1f}); |offset| <= rtt on each rank (offsets us "
        f"{', '.join(f'{v:.2f}' for v in plain['offset_us'])})")
    lines.append(
        f"(b) the port's p40 under mpi_base_lockwitness=1 with CUDA "
        f"payloads over devxfer: {N_RANKS} dumps merged by tracedump, "
        f"{len(lw['edges'])} edges over {len(lw['sites'])} sites, acyclic, "
        f"max hold {lw['max_hold_us']:.1f} us; every rank OK, rc 0, no "
        f"otpt* file left; jobs {wit_s:.1f} s (witness) and {plain_s:.1f} s "
        f"(plain)")
    lines.append(
        f"(b) 8 B allreduce host us on {N_RANKS} ranks of cuda:0 (rank 0, "
        f"1000 calls): witness on {wit['us_8b']:.2f}, off "
        f"{plain['us_8b']:.2f} ({wit['us_8b'] / plain['us_8b'] - 1:+.1%})")
    job_s = time.perf_counter() - t0
    for line in lines:
        phase("tools", f"{line} | {smi}")
    check(world_s + job_s < TLS_PHASE_S,
          f"phase 18 took {world_s + job_s:.1f} s")
    phase("tools", f"per-rank part {job_s:.1f} s; phase 18 took "
          f"{world_s + job_s:.1f} s (limit {TLS_PHASE_S} s) | {smi}")


# -- phase 19 ----------------------------------------------------------
# (program, ranks) of the C conformance programs the phase runs on the
# card; c23_bigcount (2.1 GB, about 90 s alone) stays out
CAB_JOBS = (("c01_hello", 2), ("c03_coll", 3), ("c08_userop", 3),
            ("c11_rma", 3), ("c12_mpiio", 3), ("c13_staged", 2),
            ("c14_icoll_full", 3), ("c19_mpit", 2), ("c25_spawn", 2),
            ("c35_join_mpmd", 2), ("c37_thread_comms", 2))
CAB_STAGED = "c13_staged"      # 16 Mi floats = 64 MB per rank by default
CAB_JOB_TIMEOUT = 90           # seconds each C job may take
CAB_PARALLEL = 4               # C jobs at once after c13 ran alone
CAB_PHASE_S = 150              # the whole phase must end within this
CAB_SLOT = 64 << 20            # c13's payload per rank, in bytes
# c12 writes a fixed /tmp path that another checkout's run would share:
# it is compiled from a copy whose path literal (and nothing else)
# points into the phase's own temp dir
CAB_TEMP_PATH = ("c12_mpiio", '"/tmp/ompi_tpu_c12_%d.dat"', '"{d}/c12_%d.dat"')
# A PMPI tool LD_PRELOADed under c13: at MPI_Finalize it reads, through
# MPI_T, the staged device tier's SPC counter and the device override
CAB_PROBE = r"""
#include <mpi.h>
#include <stdio.h>

int MPI_Finalize(void)
{
    int rank = -1, idx = -1, count = 0;
    unsigned long long staged = 0;
    char dev[256] = "?";
    PMPI_Comm_rank(MPI_COMM_WORLD, &rank);
    MPI_T_pvar_session ses;
    MPI_T_pvar_handle ph;
    if (MPI_T_pvar_get_index("spc_coll_staged_device", &idx)
            == MPI_SUCCESS) {
        MPI_T_pvar_session_create(&ses);
        MPI_T_pvar_handle_alloc(ses, idx, NULL, &ph, &count);
        MPI_T_pvar_read(ses, ph, &staged);
        MPI_T_pvar_handle_free(ses, &ph);
        MPI_T_pvar_session_free(&ses);
    }
    MPI_T_cvar_handle ch;
    if (MPI_T_cvar_get_index("mpi_base_device", &idx) == MPI_SUCCESS) {
        MPI_T_cvar_handle_alloc(idx, NULL, &ch, &count);
        MPI_T_cvar_read(ch, dev);
        MPI_T_cvar_handle_free(&ch);
    }
    printf("CABI_PROBE rank=%d coll_staged_device=%llu "
           "mpi_base_device='%s'\n", rank, staged, dev);
    fflush(stdout);
    return PMPI_Finalize();
}
"""


def phase_cabi_world(w, smi: str) -> tuple:
    """Phase 19 on the 8-row world of cuda:0: the single-controller C-ABI
    glue's five nonblocking-collective contracts (``tests/
    test_cabi_async.py``) against numpy. Returns (seconds, flash-fold
    launches over this part)."""
    from ompi_tpu_torch.api import cabi
    from ompi_tpu_torch.core.errhandler import MPIError
    t0 = time.perf_counter()
    before = FA.launches
    check(cabi._comm(cabi.COMM_WORLD) is w and w.device.type == "cuda",
          "the glue's COMM_WORLD is the card's world")
    n, dbl, sum_ = w.size, 14, 1

    def mv(a):
        return memoryview(np.ascontiguousarray(a).tobytes())

    def rows(v):
        return np.tile(np.asarray([v], np.float64), (n, 1))
    # (1) async issue: the i-call returns a worker request
    buf = np.arange(n, dtype=np.float64)
    rh = cabi.ireduce(cabi.COMM_WORLD, mv(buf), dbl, sum_, 0)
    with cabi._lock:
        kind = type(cabi._requests[rh][0]).__name__
    check(kind == "_AsyncBytesReq", f"ireduce took {kind}")
    while True:
        got = cabi.test(rh)
        if got[0]:
            break
    check(np.frombuffer(got[1], np.float64)[0] == buf.sum(), "ireduce")
    # (2) issue order on the serial worker
    r1 = cabi.iscan(cabi.COMM_WORLD, mv(rows(1.0)), dbl, sum_)
    r2 = cabi.iscan(cabi.COMM_WORLD, mv(rows(10.0)), dbl, sum_)
    ramp = np.arange(1, n + 1, dtype=np.float64)
    check(np.array_equal(np.frombuffer(cabi.wait(r1)[0], np.float64), ramp)
          and np.array_equal(np.frombuffer(cabi.wait(r2)[0], np.float64),
                             10 * ramp), "iscan issue order")
    # (3) a deferred error surfaces at wait and frees the request
    rh = cabi.ireduce(cabi.COMM_WORLD, mv(rows(1.0)), 9999, sum_, 0)
    try:
        cabi.wait(rh)
        check(False, "a bad datatype handle completed")
    except MPIError as e:
        err = e.error_class
    with cabi._lock:
        check(rh not in cabi._requests, "errored request kept")
    # (4) the worker retires with its comm
    h = cabi.comm_dup(cabi.COMM_WORLD)
    rh = cabi.igather(h, mv(rows(2.0)), dbl, 0, dbl)
    with cabi._lock:
        check(h in cabi._icoll_workers, "no worker for the dup")
    # the stacked result: the root's gathered row on every row
    check(np.array_equal(np.frombuffer(cabi.wait(rh)[0], np.float64),
                         np.full(n * n, 2.0)), "igather")
    cabi.comm_free(h)
    with cabi._lock:
        check(h not in cabi._icoll_workers, "worker outlived comm_free")
    # (5) comm_free drains the pending collectives
    h = cabi.comm_dup(cabi.COMM_WORLD)
    rhs = [cabi.iscan(h, mv(rows(1.0)), dbl, sum_) for _ in range(4)]
    cabi.comm_free(h)
    check(all(np.array_equal(np.frombuffer(cabi.wait(r)[0], np.float64),
                             ramp) for r in rhs), "drained iscans")
    s = time.perf_counter() - t0
    phase("cabi", f"(a) the glue's 5 nonblocking contracts on the 8-row "
          f"world of {w.device}: async issue (_AsyncBytesReq), issue "
          f"order, deferred error at wait (class {err}, request freed), "
          f"worker retired with its comm, comm_free drains 4 iscans; = "
          f"numpy; {s:.2f} s | {smi}")
    return s, FA.launches - before


def _cab_build(tmp: str) -> tuple:
    """The port's library and the phase's programs, built from the
    checkout by the port's mpicc (its ``main``, one gcc per program, in
    parallel). Returns ({name: binary}, probe, tool, library seconds,
    seconds)."""
    from concurrent.futures import ThreadPoolExecutor
    from ompi_tpu_torch.tools import mpicc
    root = os.path.dirname(os.path.abspath(__file__))
    progs = os.path.join(root, "tests", "cabi_programs")
    t0 = time.perf_counter()
    so = mpicc.build_lib()
    lib_s = time.perf_counter() - t0
    check(so.resolve().parent == mpicc.BUILD_DIR, f"library {so}")
    probe_c = os.path.join(tmp, "cabi_probe.c")
    with open(probe_c, "w") as f:
        f.write(CAB_PROBE)
    srcs = {name: os.path.join(progs, f"{name}.c") for name, _ in CAB_JOBS}
    name, old, new = CAB_TEMP_PATH
    with open(srcs[name]) as f:
        text = f.read()
    check(text.count(old) == 1 and len(tmp) < 200,
          f"{name}.c holds {text.count(old)} of {old}")
    srcs[name] = os.path.join(tmp, f"{name}.c")
    with open(srcs[name], "w") as f:
        f.write(text.replace(old, new.format(d=tmp)))
    units = [(srcs[name], os.path.join(tmp, name), ())
             for name, _ in CAB_JOBS]
    units.append((probe_c, os.path.join(tmp, "cabi_probe.so"),
                  ("-shared", "-fPIC")))
    units.append((os.path.join(progs, "pmpi_tool.c"),
                  os.path.join(tmp, "pmpi_tool.so"), ("-shared", "-fPIC")))

    def cc(unit):
        src, out, extra = unit
        check(mpicc.main([*extra, src, "-o", out]) == 0, f"mpicc {src}")
        return out
    with ThreadPoolExecutor(len(units)) as pool:
        outs = list(pool.map(cc, units))
    bins = {name: out for (name, _), out in zip(CAB_JOBS, outs)}
    return bins, outs[-2], outs[-1], lib_s, time.perf_counter() - t0


class _FreeWatch:
    """The least free memory of cuda:0 while a job runs
    (``torch.cuda.mem_get_info`` is the device's, so it sees the rank
    processes' contexts and buffers), polled every 20 ms."""

    def __init__(self):
        import threading
        self.base = torch.cuda.mem_get_info(0)[0]
        self.low = self.base
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._poll, daemon=True)
        self._th.start()

    def _poll(self):
        while not self._stop.wait(0.02):
            self.low = min(self.low, torch.cuda.mem_get_info(0)[0])

    def drop_mib(self) -> float:
        self._stop.set()
        self._th.join()
        return (self.base - self.low) / 2 ** 20


def _cab_job(binary: str, n: int, cwd: str, args=(), preload="") -> tuple:
    """One C program under the port's mpirun --per-rank, with no device
    override: every rank binds cuda:0. The job's name server is a file
    of its own under ``cwd``. Returns (stdout, seconds)."""
    import signal
    import tempfile
    root = os.path.dirname(os.path.abspath(__file__))
    mpirun = os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("OMPI_TPU_TORCH_")}
    if preload:
        env["LD_PRELOAD"] = preload
    env["OMPI_TPU_TORCH_NAME_SERVER_FILE"] = os.path.join(
        tempfile.mkdtemp(dir=cwd), "names.json")
    cmd = [sys.executable, mpirun, "--per-rank", "-n", str(n), "--timeout",
           str(CAB_JOB_TIMEOUT), binary, *args]
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=cwd, env=env,
                         start_new_session=True)
    try:
        so, se = p.communicate(timeout=CAB_JOB_TIMEOUT + 5)
    except subprocess.TimeoutExpired:
        so, se = "", "killed at the job's limit"
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    s = time.perf_counter() - t0
    name = os.path.basename(binary)
    marker = f"OK {name}"
    if p.returncode != 0 or so.count(marker) != n:
        sys.stderr.write(se[-6000:])
        check(False, f"{name} on {n} ranks: rc={p.returncode}, "
              f"{so.count(marker)} of {n} OK:\n{so[-3000:]}")
    return so, s


def phase_cabi_job(smi: str, world: tuple) -> int:
    """Phase 19's C jobs on cuda:0: build, c13 alone under the MPI_T
    probe (the staged tier's counter on every rank, its own timing line,
    cuda:0's free memory during the job), then the other programs and
    the PMPI tool under c03, ``CAB_PARALLEL`` at a time. ``world`` is
    ``phase_cabi_world``'s (seconds, launches). Returns the flash-fold
    launches of phase 19 in this process: part (a) and the controller
    of part (b). The counter lives in each process, so the C ranks'
    launches are not in it; no C entry point reaches the attention
    forward, whose only caller is ``entry()``'s model."""
    import glob
    import re as _re
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from ompi_tpu_torch.accelerator import SHM_DIR
    t0 = time.perf_counter()
    before = FA.launches
    lines = []
    shm_before = set(glob.glob(os.path.join(SHM_DIR, "otpt*")))
    with tempfile.TemporaryDirectory() as tmp:
        bins, probe, tool, lib_s, build_s = _cab_build(tmp)
        lines.append(f"(b) built libtpumpi_torch.so in {lib_s:.2f} s and "
                     f"{len(bins)} programs + the MPI_T probe + the PMPI "
                     f"tool with the port's mpicc in {build_s:.2f} s")
        n13 = dict(CAB_JOBS)[CAB_STAGED]
        watch = _FreeWatch()
        out, s13 = _cab_job(bins[CAB_STAGED], n13, tmp, preload=probe)
        drop = watch.drop_mib()
        probes = _re.findall(r"CABI_PROBE rank=(\d+) coll_staged_device="
                             r"(\d+) mpi_base_device='([^']*)'", out)
        check(sorted(int(r) for r, _, _ in probes) == list(range(n13)),
              f"probe lines {probes}")
        staged = {int(r): int(c) for r, c, _ in probes}
        check(all(c > 0 for c in staged.values()),
              f"coll_staged_device per rank {staged}")
        check(all(d == "" for _, _, d in probes),
              f"a device override reached the ranks: {probes}")
        check(drop >= n13 * CAB_SLOT / 2 ** 20,
              f"cuda:0 free memory fell by {drop:.0f} MiB in c13's job")
        timing = _re.search(r"timing n=\d+ allreduce=[\d.]+ ms "
                            r"bcast=[\d.]+ ms", out)
        check(timing is not None, f"c13's timing line: {out[-2000:]}")
        lines.append(
            f"(b) c13_staged on {n13} ranks (16 Mi floats = 64 MB per rank, "
            f"no device override; probe: mpi_base_device unset on every "
            f"rank): {timing.group(0)}; coll_staged_device per rank "
            f"{[staged[r] for r in range(n13)]} (MPI_T, read at "
            f"MPI_Finalize); cuda:0 free memory fell by {drop:.0f} MiB "
            f"during the job; job {s13:.1f} s")
        # the rest, and c03 again under the PMPI tool, four at a time
        rest = [(name, n, "") for name, n in CAB_JOBS if name != CAB_STAGED]
        rest.append(("c03_coll", 3, tool))

        def run(job):
            name, n, preload = job
            so, s = _cab_job(bins[name], n, tmp, preload=preload)
            return name, n, s, so
        watch = _FreeWatch()
        with ThreadPoolExecutor(CAB_PARALLEL) as pool:
            done = list(pool.map(run, rest))
        drop = watch.drop_mib()
        *done, (_, _, s_tool, so) = done
        tool_lines = [ln for ln in so.splitlines()
                      if ln.startswith("PMPI_TOOL")]
        check(len(tool_lines) == 3 and all(
            "allreduce=1" in ln and "bcast=1" in ln for ln in tool_lines),
            f"PMPI tool lines {tool_lines}")
        lines.append(
            f"(b) OK on every rank, seconds per job ({CAB_PARALLEL} at a "
            f"time): " + ", ".join(
                f"{name} n={n} {s:.1f}" for name, n, s, _ in done)
            + f"; pmpi_tool.so LD_PRELOADed under c03_coll n=3: "
            f"allreduce=1 bcast=1 on 3 ranks, {s_tool:.1f} s; cuda:0 free "
            f"memory fell by up to {drop:.0f} MiB")
    left = set(glob.glob(os.path.join(SHM_DIR, "otpt*"))) - shm_before
    check(not left, f"files left: {sorted(left)}")
    world_s, launched = world
    launched += FA.launches - before
    check(launched == 0, f"{launched} flash_fold launches in phase 19")
    job_s = time.perf_counter() - t0
    for line in lines:
        phase("cabi", f"{line} | {smi}")
    phase("cabi", f"flash_fold launches over phase 19 in the controller "
          f"process (parts a and b): {launched}; no "
          f"otpt* file left; per-rank part {job_s:.1f} s; phase 19 took "
          f"{world_s + job_s:.1f} s (aim {CAB_PHASE_S} s) | {smi}")
    return launched



# -- phase 20 ----------------------------------------------------------
MC_HOSTS = 2                   # controller processes
MC_ROWS = 4                    # rows each controller holds on cuda:0
MC_JOB_TIMEOUT = 150           # seconds the job may take (phases 20, 21)
MC_SEED = 2000
# phase 20's call -> (phase 4's name, phase 11's name) of the same call
MC_PEERS = {
    "allreduce SUM f32": ("allreduce SUM f32", "allreduce SUM f32"),
    "allreduce MAX f32": ("allreduce MAX f32", "allreduce MAX f32"),
    "allreduce PROD f32": ("allreduce PROD f32", "allreduce PROD f32"),
    "allreduce SUM i32": ("allreduce SUM i32", "allreduce SUM i32"),
    "reduce MIN root 2": ("reduce MIN root 2", None),
    "bcast root 3": ("bcast root 3", "bcast root 3"),
    "allgather": ("allgather", "allgather"),
    "gather root 1": ("gather root 1", None),
    "scatter root 5": ("scatter root 5", None),
    "alltoall": ("alltoall", "alltoall"),
    "reduce_scatter_block SUM": ("reduce_scatter_block SUM",
                                 "reduce_scatter_block (alltoall + host "
                                 "fold)"),
    "scan SUM": ("scan SUM", None),
    "barrier": ("barrier", None),
}


def _mc_inputs(n: int) -> list:
    """Every rank's 32 MB fp32 input, made from the seed by every
    controller (the global array each passes to ``stack``)."""
    return [np.random.default_rng(MC_SEED + j).random(LOCAL_ELEMS,
                                                      dtype=np.float32)
            for j in range(n)]


def _multictl_rank(t_launch: float, report: str) -> int:
    """One controller of phase 20 (run by ``mpirun --coordinator``):
    checks every collective on its own rows; controller 0 writes its
    lines and both write their numbers to ``report``."""
    from ompi_tpu_torch.core import rankcomm
    from ompi_tpu_torch.core.errhandler import MPIError
    from ompi_tpu_torch.core.multictl import Rows
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    MPI.Init(devices=[dev] * MC_ROWS)
    init_s = time.perf_counter() - t0
    up_s = time.time() - t_launch
    w = MPI.get_comm_world()
    me = int(os.environ["OMPI_TPU_TORCH_MCA_mpi_base_process_id"])
    n = w.size
    mine = list(w._local)
    check(n == MC_HOSTS * MC_ROWS and w.spans_processes
          and w.is_multiprocess, f"world of {n} rows spanning controllers")
    check(mine == list(range(me * MC_ROWS, (me + 1) * MC_ROWS)),
          f"controller {me} holds {mine}")
    check(all(d == dev for d in w.devices) and w.device == dev,
          "every row on cuda:0")
    dmod = w._coll("allreduce").device
    low, high = dmod._groups()
    check(low == [[0, 1, 2, 3], [4, 5, 6, 7]]
          and high == [[0, 4], [1, 5], [2, 6], [3, 7]],
          f"_groups() = {low} / {high}")
    lines, nums = [], {"controller": me, "init_s": init_s, "up_s": up_s}
    fl0 = FA.launches
    xs = _mc_inputs(n)
    stack = np.stack(xs)
    s64 = stack.astype(np.float64)
    per = LOCAL_ELEMS // n
    x = w.stack(xs)
    xp = w.stack([0.5 + a for a in xs])
    xi = w.stack([(a * 1000).astype(np.int32) for a in xs])
    yw = w.stack([a.reshape(n, per) for a in xs])     # (N, N, per) rows

    def host(y, what):
        """The local rows of a result, checked to be on cuda:0."""
        check(isinstance(y, Rows) and y.local.device == dev
              and y.ranks == tuple(mine), f"{what}: not this controller's "
              f"rows on cuda:0")
        return y.local.cpu().numpy()

    def same(got, want, what, rtol=0.0):
        if rtol:
            ok = np.allclose(got, want, rtol=rtol, atol=1e-5)
        else:
            ok = np.array_equal(got, want)
        check(ok, f"controller {me}: {what} differs from numpy (max abs "
              f"err {np.max(np.abs(got.astype(np.float64) - want)):.3g})")

    def timed(name, fn, want_fn, rtol=0.0):
        """Run, check, time and count the tier bytes of one call."""
        b0 = dict(rankcomm.tier_bytes)
        y = fn()
        moved = {k: rankcomm.tier_bytes[k] - b0[k] for k in b0}
        same(*want_fn(y), name, rtol)
        del y
        _, ms, us = _pr_timed(fn, iters=3)
        nums.setdefault("bytes", {})[name] = moved
        nums.setdefault("ms", {})[name] = (ms, us)
        return ms

    rows = np.asarray(mine)
    auto = {}
    for func, buf, op in (("allreduce", x, MPI.SUM), ("bcast", x, None),
                          ("allgather", x, None),
                          ("reduce_scatter_block", yw, MPI.SUM)):
        auto[func] = w._coll(func).selected(func, buf, op,
                                            3 if func == "bcast" else None)
    auto["barrier"] = w._coll("barrier").selected("barrier")
    check(all(a == "hier" for a in auto.values()),
          f"auto picks on the spanning world: {auto}")
    timed("allreduce SUM f32", lambda: w.allreduce(x, MPI.SUM),
          lambda y: (host(y, "allreduce")[0], s64.sum(0)), 1e-5)
    timed("allreduce MAX f32", lambda: w.allreduce(x, MPI.MAX),
          lambda y: (host(y, "allreduce MAX")[0], stack.max(0)))
    timed("allreduce PROD f32", lambda: w.allreduce(xp, MPI.PROD),
          lambda y: (host(y, "allreduce PROD")[0], (0.5 + s64).prod(0)),
          1e-5)
    timed("allreduce SUM i32", lambda: w.allreduce(xi, MPI.SUM),
          lambda y: (host(y, "allreduce i32")[0], np.stack(
              [(a * 1000).astype(np.int32) for a in xs]).sum(
                  0, dtype=np.int32)))
    red = w.reduce(x, MPI.MIN, root=2)
    if 2 in mine:
        same(host(red, "reduce")[mine.index(2)], stack.min(0), "reduce MIN")
    del red
    _, ms, us = _pr_timed(lambda: w.reduce(x, MPI.MIN, root=2), iters=3)
    nums["ms"]["reduce MIN root 2"] = (ms, us)
    timed("bcast root 3", lambda: w.bcast(x, root=3),
          lambda y: (host(y, "bcast"), np.broadcast_to(stack[3],
                                                       (MC_ROWS,) +
                                                       stack[3].shape)))

    def ag_check(y):
        check(all(torch.equal(y.local[a], y.local[0])
                  for a in range(1, MC_ROWS)), "allgather rows differ")
        return y.local[0].cpu().numpy(), stack
    timed("allgather", lambda: w.allgather(x), ag_check)
    g = w.gather(x, root=1)
    if 1 in mine:
        same(g.local[mine.index(1)].cpu().numpy(), stack, "gather")
    del g
    _, ms, us = _pr_timed(lambda: w.gather(x, root=1), iters=3)
    nums["ms"]["gather root 1"] = (ms, us)
    yh = stack.reshape(n, n, per)
    timed("scatter root 5", lambda: w.scatter(yw, root=5),
          lambda y: (host(y, "scatter"), yh[5][rows]))
    timed("alltoall", lambda: w.alltoall(yw),
          lambda y: (host(y, "alltoall"), np.swapaxes(yh, 0, 1)[rows]))
    timed("reduce_scatter_block SUM",
          lambda: w.reduce_scatter_block(yw, MPI.SUM),
          lambda y: (host(y, "reduce_scatter_block"),
                     s64.reshape(n, n, per).sum(0)[rows]), 1e-5)
    timed("scan SUM", lambda: w.scan(x, MPI.SUM),
          lambda y: (host(y, "scan"), np.cumsum(s64, axis=0)[rows]), 1e-5)
    _, ms, us = _pr_timed(w.barrier, iters=20)
    nums["ms"]["barrier"] = (ms, us)

    # hier forced, and direct forced: across controllers both name the
    # one exchange (coll/torch_'s one-exchange bodies), so ``selected`` reports
    # the forced name and the results are the same bits
    hd = []
    for func, fn in (
            ("allreduce", lambda: w.allreduce(x, MPI.SUM)),
            ("bcast", lambda: w.bcast(x, root=6)),
            ("allgather", lambda: w.allgather(x)),
            ("reduce_scatter_block",
             lambda: w.reduce_scatter_block(yw, MPI.SUM))):
        out = {}
        for alg in ("hier", "direct"):
            var.var_set(f"coll_torch_{func}_algorithm", alg)
            ran = w._coll(func).selected(
                func, yw if func == "reduce_scatter_block" else x,
                None if func in ("bcast", "allgather") else MPI.SUM,
                6 if func == "bcast" else None)
            check(ran == alg, f"{func} forced {alg} ran {ran}")
            out[alg] = fn()
        var.var_set(f"coll_torch_{func}_algorithm", "auto")
        a, b = out["hier"].local, out["direct"].local
        check(torch.equal(a, b), f"{func}: hier differs from direct")
        hd.append(func)
        del out, a, b
    for alg in ("hier", "direct"):
        var.var_set("coll_torch_barrier_algorithm", alg)
        check(w._coll("barrier").selected("barrier") == alg, "barrier alg")
        w.barrier()
    var.var_set("coll_torch_barrier_algorithm", "auto")
    hd.append("barrier")

    # the compressed hier allreduce: only the crossing chunk quantized
    var.var_set("mpi_base_compress", True)     # the calls gate on it
    cw = w.dup()
    ran = cw._coll("allreduce").selected("allreduce", x, MPI.SUM)
    check(ran == "compressed:int8_block", f"compressed dup ran {ran}")
    yc = host(cw.allreduce(x, MPI.SUM), "compressed allreduce")
    ref = s64.sum(0)
    err = float(np.abs(yc[0] - ref).max())
    bound = 0.02 * float(np.abs(ref).max())
    check(err <= bound and all(np.array_equal(yc[a], yc[0])
                               for a in range(MC_ROWS)),
          f"compressed allreduce error {err:.3g} > {bound:.3g}")
    _, cms, _us = _pr_timed(lambda: cw.allreduce(x, MPI.SUM), iters=3)
    nums["compressed"] = (err, bound, cms)
    cw.free()
    var.var_set("mpi_base_compress", False)
    del yc

    # a plain CUDA tensor is the global stack every controller passes
    small = torch.from_numpy(stack[:, :1024].copy()).to(dev)
    yt = w.allreduce(small, MPI.SUM)
    same(host(yt, "global tensor allreduce")[0], s64[:, :1024].sum(0),
         "global tensor allreduce", 1e-5)

    # a split spanning both controllers: ranks {0, 2, 4, 6} and {1, 3, ...}
    sub = w.split([r % 2 for r in range(n)])[mine[0]]
    check(sub.spans_processes and sub.size == n // 2, "spanning split")
    sy = sub.allreduce(sub.stack([xs[r] for r in range(0, n, 2)]), MPI.SUM)
    same(sy.local[0].cpu().numpy(), s64[0::2].sum(0), "split allreduce",
         1e-5)
    del sy

    # the guards
    w.set_errhandler(MPI.ERRORS_RETURN)
    guarded = 0
    for fn in (lambda: w.send(np.zeros(2), 0, 1),
               lambda: w.recv(0, dst=1), lambda: w.probe(0),
               lambda: MPI.Win(w, 8),
               lambda: __import__("ompi_tpu_torch.shmem.api", fromlist=[
                   "ShmemCtx"]).ShmemCtx(w, heap_size=16),
               lambda: w.allgatherv([np.zeros(r + 1) for r in range(n)])):
        try:
            fn()
        except MPIError as e:
            check("single-controller" in str(e), f"guard said {e}")
            guarded += 1
    check(guarded == 6, f"{guarded} of 6 guards raised")
    try:
        w.shard(x, (1 - me) * MC_ROWS)
        check(False, "a remote row was read")
    except MPIError as e:
        check(e.error_class == MPI.ERR_RANK, f"remote row: {e}")
    w.set_errhandler(MPI.ERRORS_ARE_FATAL)

    crossing, dups = _multictl_planes(w, me, xs, x, xi, nums, same)
    crossing.update(_multictl_schedules(w, me, dev, nums))
    # no payload crosses through the host: the allreduce and bcast that
    # cross controllers, and han's and xhc's allreduce, copy nothing of
    # payload size device-to-host. One profiler session for all of them:
    # a controller process's later sessions can lose their memcpy
    # records, which the .cpu() control would then show
    dtoh = _dtoh_split({"allreduce": lambda: w.allreduce(x, MPI.SUM),
                        "bcast": lambda: w.bcast(x, root=6),
                        **crossing,
                        "control .cpu()": lambda: x.local.cpu()})
    payload = LOCAL_ELEMS * 4
    for name in dtoh:
        cnt, nbytes = dtoh[name]
        if name == "control .cpu()":
            check(cnt >= 1 and nbytes >= MC_ROWS * payload,
                  f"the .cpu() control saw {cnt} DtoH records, {nbytes} "
                  f"bytes")
        else:
            check(cnt == 0 or nbytes < payload,
                  f"{name}: {cnt} DtoH records, {nbytes} bytes")
    nums["dtoh"] = dtoh
    for d in dups:
        d.free()
    nums["flash_fold"] = FA.launches - fl0
    check(nums["flash_fold"] == 0, "a flash-fold launch in phase 20")
    nums["auto"] = auto
    nums["hier_vs_direct"] = hd
    MPI.Finalize()
    with open(report, "w") as f:
        json.dump(nums, f)
    print(f"OK multictl controller={me}", flush=True)
    return 0


def _multictl_planes(w, me: int, xs: list, x, xi, nums: dict,
                     same) -> tuple:
    """Phase 20's planes on one controller: the Session psets and the
    comms made from ``mpi://WORLD`` and ``mpix://shared/<me>``; mpisync's
    table; han, then xhc, forced by priority on a dup of COMM_WORLD,
    against numpy and the forced direct schedule (32 MB fp32 per rank).
    Returns han's and xhc's crossing allreduce, for the ``Memcpy DtoH``
    count, and their dups, to free after it."""
    from ompi_tpu_torch.core.multictl import Rows
    from ompi_tpu_torch.runtime.session import Session
    from ompi_tpu_torch.tools import mpisync
    n = w.size
    mine = list(w._local)
    stack = np.stack(xs)
    s64 = stack.astype(np.float64)
    i32 = np.stack([(a * 1000).astype(np.int32) for a in xs])
    ms = nums.setdefault("planes_ms", {})

    def rows_of(y, comm, what):
        check(isinstance(y, Rows) == comm.is_multiprocess, what)
        t = y.local if isinstance(y, Rows) else y
        check(t.device == w.device, f"{what}: not on {w.device}")
        return t.cpu().numpy()

    def timed(name, fn):
        _, m, us = _pr_timed(fn, iters=3)
        ms[name] = (m, us)

    # -- Sessions: the psets list the world's ranks, one shared pset per
    # controller; comms from them are stacked session comms
    sess = Session()
    want = {"mpi://WORLD": list(range(n)), "mpi://SELF": [0]}
    for c in range(MC_HOSTS):
        want[f"mpix://shared/{c}"] = list(range(c * MC_ROWS,
                                                (c + 1) * MC_ROWS))
    check(sess._psets == want, f"Session psets {sess._psets}")
    cw = sess.comm_create_from_group(sess.group_from_pset("mpi://WORLD"))
    cs = sess.comm_create_from_group(
        sess.group_from_pset(f"mpix://shared/{me}"))
    check(type(cw).__name__ == "SessionCommunicator"
          and cw.is_multiprocess and cw.spans_processes
          and not cs.is_multiprocess and cs.size == MC_ROWS,
          "the session comms")
    xw = cw.stack(xs)
    same(rows_of(cw.allreduce(xw, MPI.SUM), cw, "session WORLD allreduce"),
         np.broadcast_to(s64.sum(0), (MC_ROWS, s64.shape[1])),
         "session WORLD allreduce", 1e-5)
    timed("session WORLD allreduce SUM f32",
          lambda: cw.allreduce(xw, MPI.SUM))
    same(rows_of(cw.bcast(xw, 5), cw, "session WORLD bcast"),
         np.broadcast_to(stack[5], (MC_ROWS, stack.shape[1])),
         "session WORLD bcast root 5")
    timed("session WORLD bcast root 5", lambda: cw.bcast(xw, 5))
    local = [xs[r] for r in mine]
    xl = cs.stack(local)
    ls64 = np.stack(local).astype(np.float64)
    same(rows_of(cs.allreduce(xl, MPI.SUM), cs, "session shared allreduce"),
         np.broadcast_to(ls64.sum(0), ls64.shape),
         f"session shared/{me} allreduce", 1e-5)
    timed(f"session shared/{me} allreduce SUM f32",
          lambda: cs.allreduce(xl, MPI.SUM))
    same(rows_of(cs.bcast(xl, 1), cs, "session shared bcast"),
         np.broadcast_to(local[1], (MC_ROWS,) + local[1].shape),
         f"session shared/{me} bcast root 1")
    timed(f"session shared/{me} bcast root 1", lambda: cs.bcast(xl, 1))
    del xw, xl
    sess.finalize()

    # -- mpisync: this controller's rows read its clock, the other's
    # are unprobed
    table = mpisync.sync_report(w, rounds=2)
    for r, row in enumerate(table):
        if r in mine:
            check((row["clock"], row["offset_s"]) == ("controller", 0.0),
                  f"mpisync rank {r}: {row}")
        else:
            check(row["clock"] == f"process_{1 - me} (unprobed)"
                  and row["offset_s"] is None and row["rtt_s"] is None,
                  f"mpisync rank {r}: {row}")
    nums["mpisync"] = [row["clock"] for row in table]

    # -- han, then xhc, forced by priority on COMM_WORLD; the vars this
    # sets are put back to what was in force
    saved = {k: var.var_get(k) for k in (
        "coll_torch_allreduce_algorithm", "coll_torch_bcast_algorithm",
        "coll_han_priority", "coll_xhc_priority")}
    try:
        return _multictl_forced(w, x, xi, stack, s64, i32, rows_of, same,
                                timed, saved)
    finally:
        for k, v in saved.items():
            var.var_set(k, v)


def _multictl_forced(w, x, xi, stack, s64, i32, rows_of, same, timed,
                     saved: dict) -> tuple:
    """han, then xhc, forced by priority on a dup of COMM_WORLD, against
    numpy and the forced direct schedule (``_multictl_planes``)."""
    var.var_set("coll_torch_allreduce_algorithm", "direct")
    var.var_set("coll_torch_bcast_algorithm", "direct")
    direct = {"SUM f32": w.allreduce(x, MPI.SUM).local.cpu().numpy(),
              "MAX f32": w.allreduce(x, MPI.MAX).local.cpu().numpy(),
              "SUM i32": w.allreduce(xi, MPI.SUM).local.cpu().numpy(),
              "bcast": w.bcast(x, 3).local.cpu().numpy()}
    for f in ("allreduce", "bcast"):
        k = f"coll_torch_{f}_algorithm"
        var.var_set(k, saved[k])
    want_np = {"SUM f32": s64.sum(0), "MAX f32": stack.max(0),
               "SUM i32": i32.sum(0, dtype=np.int32), "bcast": stack[3]}
    crossing, dups = {}, []
    for comp, mod in (("han", "HanModule"), ("xhc", "XhcModule")):
        var.var_set(f"coll_{comp}_priority", 100)
        d = w.dup()
        var.var_set(f"coll_{comp}_priority", -1)
        for f in ("allreduce", "bcast"):
            got = type(d.c_coll[f]).__name__
            check(got == mod, f"{comp} forced: {f} provided by {got}")
        calls = {"SUM f32": lambda: d.allreduce(x, MPI.SUM),
                 "MAX f32": lambda: d.allreduce(x, MPI.MAX),
                 "SUM i32": lambda: d.allreduce(xi, MPI.SUM),
                 "bcast": lambda: d.bcast(x, 3)}
        for name, fn in calls.items():
            y = rows_of(fn(), d, f"{comp} {name}")
            rtol = 1e-5 if name == "SUM f32" else 0.0
            same(y, np.broadcast_to(want_np[name], y.shape),
                 f"{comp} {name}", rtol)
            if rtol:
                ok = np.allclose(y, direct[name], rtol=rtol, atol=1e-5)
            else:
                ok = np.array_equal(y, direct[name])
            check(ok, f"{comp} {name} differs from the direct schedule")
            del y
            label = (f"{comp} allreduce {name}" if name != "bcast"
                     else f"{comp} bcast root 3")
            timed(label, fn)
        crossing[f"{comp} allreduce"] = (
            lambda d=d: d.allreduce(x, MPI.SUM))
        dups.append(d)
    return crossing, dups


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multictl(smi: str) -> int:
    """Launch the two controllers, relay their numbers; returns the
    flash-fold launches the phase made (0)."""
    import signal
    import tempfile
    from ompi_tpu_torch.accelerator import SHM_DIR, tag_for
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    mpirun = os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        reports = [os.path.join(tmp, f"c{h}.json") for h in range(MC_HOSTS)]
        t_launch = time.time()
        procs = [subprocess.Popen(
            [sys.executable, mpirun, "--coordinator", f"127.0.0.1:{port}",
             "--num-hosts", str(MC_HOSTS), "--host-id", str(h), "-n",
             str(MC_ROWS), os.path.abspath(__file__), "--multictl-rank",
             repr(t_launch), reports[h]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=root, start_new_session=True) for h in range(MC_HOSTS)]
        deadline = time.monotonic() + MC_JOB_TIMEOUT
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                out, err = "", "killed at the phase's limit"
            outs.append((out, err))
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        job_s = time.perf_counter() - t0
        for h, (p, (out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"OK multictl controller={h}" not in out:
                sys.stderr.write(err[-6000:])
                check(False, f"controller {h} rc={p.returncode}:\n"
                      f"{out[-3000:]}")
        nums = []
        for r in reports:
            with open(r) as f:
                nums.append(json.load(f))
    tag = tag_for(f"127.0.0.1:{port}")
    left = [f for f in os.listdir(SHM_DIR)
            if f.startswith("otpt") and f"_{tag}_" in f]
    check(not left, f"files left behind: {left}")
    check(job_s <= MC_JOB_TIMEOUT, f"the job took {job_s:.1f} s")
    c0 = nums[0]
    mib = LOCAL_ELEMS * 4 / 2 ** 20

    def peer(key, name):
        if name is None:
            return "no such call"
        v = COLL_MS.get((key, name))
        return "not run" if v is None else f"{v:.3f} ms"
    for name, (ms, us) in c0["ms"].items():
        p4, p11 = MC_PEERS.get(name, (None, None))
        moved = c0["bytes"].get(name)
        tier = (f"; tier bytes out/in per controller "
                + ", ".join(f"c{c['controller']} "
                            f"{c['bytes'][name]['out'] / 1e6:.1f}/"
                            f"{c['bytes'][name]['in'] / 1e6:.1f} MB"
                            for c in nums)) if moved is not None else ""
        phase("multictl", f"{name}: {ms:.3f} ms call, {us:.0f} us host, "
              f"{mib:.0f} MiB per rank, 2 controllers x {MC_ROWS} rows | "
              f"phase 4 (1 controller x 8 rows, host clock): "
              f"{peer('p4', p4)}; phase 11 (8 rank processes, call): "
              f"{peer('p11', p11)}{tier} | "
              f"{smi}")
    phase("multictl", f"auto picks: {c0['auto']}; hier forced and "
          f"direct forced: selected() reports each, same bits, for "
          f"{', '.join(c0['hier_vs_direct'])} (one exchange across "
          f"controllers); _groups() [[0..3], [4..7]]"
          f" / [[0, 4], [1, 5], [2, 6], [3, 7]]")
    err, bound, cms = c0["compressed"]
    phase("multictl", f"compressed hier allreduce (int8_block): max abs "
          f"err {err:.4g} <= {bound:.4g}, {cms:.3f} ms call | {smi}")
    for c in nums:
        d = c["dtoh"]
        phase("multictl", f"controller {c['controller']}: Memcpy DtoH "
              f"records (count, bytes) in one profiler session: "
              f"allreduce {d['allreduce']}, bcast {d['bcast']}, han "
              f"allreduce {d['han allreduce']}, xhc allreduce "
              f"{d['xhc allreduce']}, control .cpu() "
              f"{d['control .cpu()']}; "
              f"Init {c['init_s']:.2f} s, launch to Init done "
              f"{c['up_s']:.2f} s; flash-fold launches {c['flash_fold']}")
    ms20 = c0["ms"]
    for name, (ms, us) in c0["planes_ms"].items():
        base = ("bcast root 3" if "bcast" in name else
                "allreduce MAX f32" if "MAX" in name else
                "allreduce SUM i32" if "i32" in name else
                "allreduce SUM f32")
        phase("multictl", f"{name}: {ms:.3f} ms call, {us:.0f} us host, "
              f"{mib:.0f} MiB per rank | beside the plain world's {base} "
              f"in this phase: {ms20[base][0]:.3f} ms call | {smi}")
    phase("multictl", f"Session psets = the world's ranks, shared/0 "
          f"[0..3], shared/1 [4..7]; WORLD and shared comms = numpy; "
          f"han and xhc forced: HanModule / XhcModule provide allreduce "
          f"and bcast, = numpy and = direct (MAX, i32, bcast bit for bit, "
          f"SUM rtol 1e-5); mpisync on controller 0: {c0['mpisync']}")
    phase("multictl", "'ms call' is a CUDA-event span on controller 0's "
          "stream that includes the tier's host fences; each controller "
          "checked its rows against numpy (float SUM/PROD/scan rtol 1e-5, "
          "the rest exact), the guards, a spanning split; no otpt* file "
          f"left; phases 20 and 21 took {time.perf_counter() - t0:.1f} s "
          f"(limit {MC_JOB_TIMEOUT}) | {smi}")
    _report_schedules(nums, smi)
    return sum(c["flash_fold"] + c["sched"]["flash_fold"] for c in nums)


def _report_schedules(nums: list, smi: str) -> None:
    """Phase 21's lines, from both controllers' reports."""
    mib = LOCAL_ELEMS * 4 / 2 ** 20
    cases = {}
    for c in nums:
        for key, v in c["sched"]["cases"].items():
            name = " ".join(key.split()[:2])
            cases.setdefault(name, []).append(
                (c["controller"], key[len(name):].strip() or "-", v))
    for name, per in cases.items():
        runs = sorted({v["ran"] for _c, _k, v in per})
        outs = "; ".join(f"c{c} {k} {v['out']} B" for c, k, v in per)
        bits = all(v.get("bitwise", True) for _c, _k, v in per)
        phase("schedules", f"{name} forced (ran {', '.join(runs)}): "
              f"{'bit for bit' if bits else 'within rtol 1e-5 (direct)'} "
              f"against the 8-row single-controller comm, = numpy; tier "
              f"bytes out = the steps' index arrays: {outs}")
    for name, t in nums[0]["sched"]["ms"].items():
        alg = name.split()[1]
        ms, us, _out = t[alg]
        dms, dus, _dout = t["direct"]
        outs = ", ".join(f"c{c['controller']} {alg} "
                         f"{c['sched']['ms'][name][alg][2] / 1e6:.1f} MB, "
                         f"direct {c['sched']['ms'][name]['direct'][2] / 1e6:.1f}"
                         f" MB" for c in nums)
        phase("schedules", f"{name} at {mib:.0f} MiB per rank: {ms:.3f} ms "
              f"call, {us:.0f} us host | direct {dms:.3f} ms call, "
              f"{dus:.0f} us host ({ms / dms:.2f}x) | tier bytes out "
              f"{outs} | {smi}")
    for c in nums:
        s = c["sched"]
        d = c["dtoh"]
        sched_dtoh = {k: d[k] for k in d if k in s["ms"]}
        phase("schedules", f"controller {c['controller']}: {s['cases_n']} "
              f"(collective, schedule, op) cases at 1 MiB per rank and 2 "
              f"barriers, {s['bitwise']} bit for bit (the rest demoted to "
              f"direct), float SUM max abs err from numpy "
              f"{s['worst']:.3g}; nbc ring iallreduce with controller "
              f"{MC_HOSTS - 1} late = the blocking ring bit for bit: "
              + ", ".join(f"late {m}: {v['polls']} test() calls, longest "
                          f"{v['max_poll_ms']:.3f} ms, done in "
                          f"{v['done_ms']:.1f} ms"
                          for m, v in s["nbc"].items())
              + f"; Memcpy DtoH (count, bytes) of the {mib:.0f} MiB "
              f"crossings {sched_dtoh}, control .cpu() "
              f"{d['control .cpu()']}; flash-fold launches "
              f"{s['flash_fold']}; phase 21 took {s['s']:.1f} s (aim "
              f"{SCHED_PHASE_S} s) | {smi}")
    for c in nums:
        c9 = c["sched"]["c9"]
        sp = c9["spans_ms"]

        def live(v):
            return (f"{v['tiers']} tiers, {v['workers']} workers, "
                    f"{v['slot_bytes'] / 2 ** 20:.1f} MiB of slots")
        phase("schedules", f"controller {c['controller']}: C9 on dups A "
              f"(x) and B (2x), controller 0 in one order and controller 1 "
              f"in the other, each result = its comm's blocking call bit "
              f"for bit: {', '.join(c9['cases'])} (1 MiB per rank but the "
              f"last); the 32 MiB (b) pair's span "
              + ", ".join(f"{v:.3f}" for v in sp["pair"])
              + " ms against the same two calls one after the other "
              + ", ".join(f"{v:.3f}" for v in sp["seq"])
              + f" ms (CUDA events, in turns); live before the dups "
              f"{live(c9['live_before'])}, with them {live(c9['live_dups'])}"
              f", after their free {live(c9['live_after'])} | {smi}")


# -- phase 21 ----------------------------------------------------------
# The explicit schedules across controllers, in phase 20's job: every
# ring, tree and Bruck schedule forced on the spanning world.
SCHED_ELEMS = 1 << 18          # 1 MB of fp32 per rank for the checks
SCHED_ROOT = 7                 # the root forms' root (controller 1's)
SCHEDULES = tuple((f, a) for f in ("allreduce", "reduce_scatter_block",
                                   "allgather", "bcast", "reduce", "gather",
                                   "scatter", "alltoall", "scan", "barrier")
                  for a in ALGORITHMS[f][1:]
                  if a not in ("direct", "alias", "hier", "allgather"))
# timed at 32 MB per rank, each beside direct in the same run
SCHED_TIMED = (("allreduce", "ring"), ("allreduce", "ring_segmented"),
               ("allgather", "ring"), ("alltoall", "pairwise"),
               ("bcast", "binomial"))
SCHED_PHASE_S = 90             # what the phase aims to finish within


def _sched_oracle(n: int, dev):
    """An n-row single-controller comm on ``dev`` inside a controller
    process, made as phase 8 makes its cpu_world: while it is built the
    controller table is set aside, so its rows are all this process's
    and its collectives run the stacked schedules."""
    from ompi_tpu_torch.core import multictl
    saved = multictl._state["ctl"]
    multictl._state["ctl"] = None
    try:
        return MPI.Communicator(MPI.Group(range(n)), [dev] * n,
                                name="sched_oracle")
    finally:
        multictl._state["ctl"] = saved


def _sched_step_bytes(step: dict, ctl_of: list, h: int) -> int:
    """The bytes one crossing step writes off controller ``h``, from its
    index arrays: a take ships each distinct (source, slice) it owes
    another controller once per destination controller; an all-rows step
    writes this controller's rows once; an all-to-all writes each other
    controller its rows' blocks for that controller's ranks."""
    if step["kind"] == "take":
        pos = step["pos"] if step["pos"] is not None else \
            [None] * len(step["dst"])
        owed = {(ctl_of[d], s, repr(p)) for d, s, p in
                zip(step["dst"], step["src"], pos)
                if ctl_of[s] == h and ctl_of[d] != h}
        return len(owed) * sum(step["item"])
    rows = ctl_of.count(h)
    if step["kind"] == "rows":
        return rows * step["item"]
    return rows * (len(ctl_of) - rows) * step["item"]


class _SchedSteps:
    """Records the steps that cross the controller tier (takes of the
    rank axis, all-rows and all-to-all rounds) while it is entered."""

    def __init__(self):
        from ompi_tpu_torch.coll.torch_ import TorchCollModule
        from ompi_tpu_torch.core import multictl
        self.steps: list = []
        self._mod, self._take = TorchCollModule, multictl.Take
        self._saved = (multictl.Take.__call__,
                       TorchCollModule._mc_gather_rows,
                       TorchCollModule._mc_alltoall)

    def __enter__(self):
        take_call, rows, a2a = self._saved
        steps = self.steps

        def item(pos, x):
            if pos is None:
                return int(np.prod(x.shape[1:])) * x.element_size()
            d = pos.shape[1] if pos.ndim == 2 else 1
            return d * int(np.prod(x.shape[2:])) * x.element_size()

        def take(tk, *xs):
            out = take_call(tk, *xs)
            if tk.cross:
                steps.append({"kind": "take", "dst": tk.dst.tolist(),
                              "src": tk.src.tolist(),
                              "pos": None if tk.pos is None
                              else tk.pos.tolist(),
                              "item": [item(tk.pos, x) for x in xs]})
            return out

        def all_rows(mod, X):
            steps.append({"kind": "rows", "item": int(np.prod(
                X.shape[1:])) * X.element_size()})
            return rows(mod, X)

        def all_to_all(mod, X):
            steps.append({"kind": "a2a", "item": int(np.prod(
                X.shape[2:])) * X.element_size()})
            return a2a(mod, X)
        self._take.__call__ = take
        self._mod._mc_gather_rows = all_rows
        self._mod._mc_alltoall = all_to_all
        return self

    def __exit__(self, *exc):
        (self._take.__call__, self._mod._mc_gather_rows,
         self._mod._mc_alltoall) = self._saved


def _sched_call(comm, func, buf, op, root):
    args = (buf,) + ((op,) if op is not None else ()) + \
        ((root,) if root is not None else ())
    return getattr(comm, func)(*args)


def _multictl_schedules(w, me: int, dev, nums: dict) -> dict:
    """Phase 21 on one controller: every explicit schedule forced on the
    spanning world (1 MB per rank; SUM, MAX and SUM int32 for the
    reducing collectives; root 7 for the root forms), held bit for bit
    against the same schedule on an 8-row single-controller comm on the
    same device, against numpy, ``selected`` against the reference's
    rules and the tier bytes against the steps' index arrays; the five
    big schedules timed at 32 MB beside direct; the ring iallreduce with
    one controller late. Returns the 32 MB crossings, for phase 20's
    ``Memcpy DtoH`` session."""
    from ompi_tpu_torch.core import rankcomm
    t0 = time.perf_counter()
    fl0 = FA.launches
    n = w.size
    mine = list(w._local)
    ctl_of = [w.controller_of(r) for r in range(n)]
    oracle = _sched_oracle(n, dev)
    rng = np.random.default_rng(MC_SEED + 21)
    xf = rng.standard_normal((n, SCHED_ELEMS)).astype(np.float32)
    xi = rng.integers(-1000, 1000, (n, SCHED_ELEMS)).astype(np.int32)
    wide_f = xf.reshape(n, n, SCHED_ELEMS // n)
    wide_i = xi.reshape(n, n, SCHED_ELEMS // n)
    kinds = {"SUM f32": (MPI.SUM, False), "MAX f32": (MPI.MAX, False),
             "SUM i32": (MPI.SUM, True)}
    out = nums.setdefault("sched", {"cases": {}, "ms": {}})
    cases = bitwise = 0
    worst = 0.0

    def expect(func, opname, x):
        """numpy's result of ``func`` on the global ``x`` (root's row
        alone for reduce and gather)."""
        a = x.astype(np.float64) if x.dtype == np.float32 else x
        red = {"SUM": lambda v: v.sum(0, dtype=a.dtype),
               "MAX": lambda v: v.max(0)}.get(opname)
        return {
            "allreduce": lambda: np.broadcast_to(red(a), a.shape),
            "reduce": lambda: red(a),
            "reduce_scatter_block": lambda: red(a),
            "scan": lambda: (np.cumsum(a, 0, dtype=a.dtype)
                             if opname == "SUM"
                             else np.maximum.accumulate(a, 0)),
            "bcast": lambda: np.broadcast_to(x[SCHED_ROOT], x.shape),
            "allgather": lambda: np.broadcast_to(x, (n,) + x.shape),
            "gather": lambda: x,
            "scatter": lambda: x[SCHED_ROOT],
            "alltoall": lambda: np.swapaxes(x, 0, 1)}[func]()

    with _SchedSteps() as rec:
        for func, alg in SCHEDULES:
            var_name = f"coll_torch_{func}_algorithm"
            if func == "barrier":
                var.var_set(var_name, alg)
                rec.steps.clear()
                b0 = dict(rankcomm.tier_bytes)
                w.barrier()
                moved = rankcomm.tier_bytes["out"] - b0["out"]
                ran = w._coll("barrier").selected("barrier")
                check(ran == alg == oracle._coll("barrier").selected(
                    "barrier"), f"barrier {alg} ran {ran}")
                owed = sum(_sched_step_bytes(s, ctl_of, me)
                           for s in rec.steps)
                check(rec.steps and moved == owed,
                      f"barrier {alg}: {moved} B out, steps owe {owed}")
                out["cases"][f"barrier {alg}"] = {"ran": ran, "out": moved}
                var.var_set(var_name, "auto")
                continue
            reducing = func in ("allreduce", "reduce_scatter_block",
                                "reduce", "scan")
            wide = func in ("scatter", "alltoall", "reduce_scatter_block")
            root = SCHED_ROOT if func in ALG_ROOTED else None
            for kind in (kinds if reducing else ("f32",)):
                op, is_int = kinds[kind] if reducing else (None, False)
                x = (wide_i if wide else xi) if is_int else \
                    (wide_f if wide else xf)
                key = f"{func} {alg} {kind}"
                var.var_set(var_name, alg)
                buf = w.put(x)
                rec.steps.clear()
                b0 = dict(rankcomm.tier_bytes)
                y = _sched_call(w, func, buf, op, root)
                moved = rankcomm.tier_bytes["out"] - b0["out"]
                steps = list(rec.steps)
                yo = _sched_call(oracle, func, oracle.put(x), op, root)
                ran = w._coll(func).selected(func, buf, op, root)
                ran_o = oracle._coll(func).selected(func, oracle.put(x), op,
                                                    root)
                var.var_set(var_name, "auto")
                want_name = _alg_expected(func, alg, n, op)
                check(ran == ran_o == want_name,
                      f"{key}: ran {ran}, the oracle {ran_o}, the "
                      f"reference's rules {want_name}")
                got = y.local
                ref = yo[torch.as_tensor(mine, device=yo.device)]
                explicit = ran not in ("direct", "alias", "allgather")
                same = torch.equal(got, ref)
                if explicit:
                    check(same, f"{key}: differs from the single-controller "
                                f"comm's bits")
                else:
                    check(bool(torch.allclose(got.double(), ref.double(),
                                              rtol=1e-5, atol=1e-5)),
                          f"{key}: differs from the single-controller comm")
                bitwise += same
                cases += 1
                # numpy: float SUM rtol 1e-5, the rest exact (PERF.md 2)
                want = expect(func, kind.split()[0] if reducing else None, x)
                host = got.cpu().numpy()
                if func in ("reduce", "gather"):
                    pair = ((host[mine.index(root)], want) if root in mine
                            else None)
                else:
                    pair = (host, np.asarray(want)[mine])
                if pair is not None and kind == "SUM f32":
                    err = float(np.max(np.abs(pair[0] - pair[1])))
                    worst = max(worst, err)
                    check(np.allclose(*pair, rtol=1e-5, atol=1e-5),
                          f"{key}: max abs err {err:.3g} from numpy")
                elif pair is not None:
                    check(np.array_equal(*pair), f"{key}: differs from "
                                                 f"numpy")
                if explicit:
                    owed = sum(_sched_step_bytes(s, ctl_of, me)
                               for s in steps)
                    check(steps and moved == owed,
                          f"{key}: {moved} B out, its steps owe {owed}")
                out["cases"][key] = {"ran": ran, "out": moved,
                                     "bitwise": bool(same)}
                del y, yo, got, ref
    oracle.free()

    # the five big schedules at 32 MB per rank, each beside direct
    xs = _mc_inputs(n)
    x32 = w.stack(xs)
    per = LOCAL_ELEMS // n
    y32 = w.stack([a.reshape(n, per) for a in xs])
    args = {"allreduce": (x32, MPI.SUM, None), "allgather": (x32, None, None),
            "alltoall": (y32, None, None), "bcast": (x32, None, SCHED_ROOT)}
    crossing = {}
    for func, alg in SCHED_TIMED:
        buf, op, root = args[func]
        var_name = f"coll_torch_{func}_algorithm"
        res = {}
        for a in (alg, "direct"):
            var.var_set(var_name, a)
            check(w._coll(func).selected(func, buf, op, root) == a,
                  f"{func} {a} at 32 MB")
            b0 = dict(rankcomm.tier_bytes)
            y = _sched_call(w, func, buf, op, root)
            moved = rankcomm.tier_bytes["out"] - b0["out"]
            if dev.type == "cuda":
                _, ms, us = _pr_timed(
                    lambda: _sched_call(w, func, buf, op, root), iters=3)
            else:
                ms = us = None
            res[a] = (y.local, ms, us, moved)
        var.var_set(var_name, "auto")
        a, b = res[alg][0], res["direct"][0]
        if op is None:
            check(torch.equal(a, b), f"{func} {alg} differs from direct")
        else:
            check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)),
                  f"{func} {alg} differs from direct at 32 MB")
        out["ms"][f"{func} {alg}"] = {k: list(v[1:]) for k, v in
                                       res.items()}
        del res, a, b

        def crossing_call(func=func, alg=alg, buf=buf, op=op, root=root):
            var.var_set(f"coll_torch_{func}_algorithm", alg)
            try:
                return _sched_call(w, func, buf, op, root)
            finally:
                var.var_set(f"coll_torch_{func}_algorithm", "auto")
        crossing[f"{func} {alg}"] = crossing_call

    # nbc's ring iallreduce, one controller late: (a) the last controller
    # sleeps before its first test(); (b) it starts its request late.
    # The others' test() returns at once; the result is the blocking
    # ring's bits
    small = w.put(xf[:, :37].copy())
    var.var_set("coll_torch_allreduce_algorithm", "ring")
    blocking = w.allreduce(small, MPI.SUM).local
    var.var_set("coll_torch_allreduce_algorithm", "auto")
    late = me == MC_HOSTS - 1
    nbc = {}
    for mode in ("test", "start"):
        if late and mode == "start":
            time.sleep(0.5)
        t1 = time.perf_counter()
        req = w.iallreduce(small, MPI.SUM)
        check(isinstance(req, ScheduleRequest), "iallreduce is nbc's")
        if late and mode == "test":
            time.sleep(0.5)
        polls = []
        while True:
            tp = time.perf_counter()
            done = req.test()[0]
            polls.append(time.perf_counter() - tp)
            if done:
                break
            check(time.perf_counter() - t1 < 30, "nbc iallreduce hung")
        check(torch.equal(req.get().local, blocking),
              f"nbc ring iallreduce ({mode} late) differs from the "
              f"blocking ring")
        check(max(polls) < 0.05, f"a test() took {max(polls):.3f} s")
        nbc[mode] = {"polls": len(polls), "max_poll_ms": max(polls) * 1e3,
                     "done_ms": (time.perf_counter() - t1) * 1e3}
    out["nbc"] = nbc
    del small, blocking
    out["c9"] = _multictl_c9(w, me, dev, xf, np.stack(xs))
    out["flash_fold"] = FA.launches - fl0
    check(out["flash_fold"] == 0, "a flash-fold launch in phase 21")
    out["cases_n"], out["bitwise"], out["worst"] = cases, bitwise, worst
    out["s"] = time.perf_counter() - t0
    check(out["s"] <= SCHED_PHASE_S, f"phase 21 took {out['s']:.1f} s")
    return crossing


def _c9_call(comm, func, buf, nb):
    """``func`` (``i<func>`` with ``nb``) on ``comm``: SUM for allreduce,
    root 7 for bcast."""
    f = ("i" if nb else "") + func
    if func == "bcast":
        return getattr(comm, f)(buf, SCHED_ROOT)
    if func == "allreduce":
        return getattr(comm, f)(buf, MPI.SUM)
    return getattr(comm, f)(buf)


def _multictl_c9(w, me: int, dev, xf, x32: np.ndarray) -> dict:
    """Phase 21's C9 programs on one controller: on fresh dups ``A``
    (input x) and ``B`` (2x) of the spanning world, controller 0 calls in
    one order and controller 1 in the other: (a) ``B.i<func>`` then the
    blocking ``A.<func>``; (b) ``A.i<func>`` and ``B.i<func>``, waited in
    start order. iallreduce SUM f32, ibcast root 7 and iallgather at 1
    MiB per rank, and a (b) iallreduce pair at 32 MiB per rank; each
    result bit for bit the same comm's blocking call. The 32 MiB pair's
    CUDA-event span beside the same two calls one after the other (same
    order everywhere), and the live tiers before and after the dups'
    ``free``."""
    from ompi_tpu_torch.core import multictl
    first = me == 0
    out = {"cases": [], "live_before": multictl.live()}
    dups = []

    def pair(func, mode, xa_host, label=""):
        A, B = w.dup(), w.dup()
        dups.extend((A, B))
        xa, xb = A.put(xa_host), B.put(xa_host * 2)
        blk_a = _c9_call(A, func, xa, False).local
        blk_b = _c9_call(B, func, xb, False).local
        if mode == "a":
            if first:
                rb = _c9_call(B, func, xb, True)
                ya = _c9_call(A, func, xa, False)
            else:
                ya = _c9_call(A, func, xa, False)
                rb = _c9_call(B, func, xb, True)
            yb = rb.get()
            reqs = [rb]
        else:
            order = [("A", A, xa), ("B", B, xb)]
            if not first:
                order.reverse()
            reqs = [_c9_call(c, func, x, True) for _n, c, x in order]
            got = dict(zip([nm for nm, _c, _x in order],
                           [r.get() for r in reqs]))
            ya, yb = got["A"], got["B"]
        check(all(isinstance(r, ScheduleRequest) for r in reqs),
              f"C9 ({mode}) {func}: the nonblocking calls are nbc's")
        check(torch.equal(ya.local, blk_a) and torch.equal(yb.local, blk_b),
              f"C9 ({mode}) {func}: a comm's result differs from its own "
              f"blocking call")
        out["cases"].append(f"({mode}) {func}{label}")
        return A, B, xa, xb

    for mode in ("a", "b"):
        for func in ("allreduce", "bcast", "allgather"):
            pair(func, mode, xf)
    # the (b) pair at 32 MiB per rank: its span against the same two
    # calls one after the other, in turns (one after the other, pair,
    # pair, one after the other)
    A, B, xa, xb = pair("allreduce", "b", x32, " 32 MiB")

    def seq():
        return [A.iallreduce(xa, MPI.SUM).get(),
                B.iallreduce(xb, MPI.SUM).get()]

    def both():
        order = [(A, xa), (B, xb)] if first else [(B, xb), (A, xa)]
        return [r.get() for r in [c.iallreduce(x, MPI.SUM)
                                  for c, x in order]]
    spans = {"seq": [], "pair": []}
    for kind in ("seq", "pair", "pair", "seq"):
        fn = seq if kind == "seq" else both
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            spans[kind].append(e0.elapsed_time(e1))
        else:
            fn()
    out["spans_ms"] = spans
    out["live_dups"] = multictl.live()
    for d in dups:
        d.free()
    out["live_after"] = multictl.live()
    check(out["live_after"] == out["live_before"],
          f"C9: tiers left after the dups' free: {out['live_after']} "
          f"against {out['live_before']} before")
    check(out["live_dups"]["tiers"] == out["live_before"]["tiers"]
          + len(dups), f"C9: {out['live_dups']['tiers']} tiers with "
          f"{len(dups)} dups live")
    return out


# -- phase 22: the multi-controller world across hosts --------------------
MH_ROWS = (4, 2, 2)            # rows of controllers 0, 1 and 2 on cuda:0
MH_HOSTS = (0, 0, 1)           # host of each: 0 and 1 on A, 2 on B
MH_JOB_TIMEOUT = 90            # seconds the job may take
MH_SEED = 2200
MH_ELEMS = 1 << 18             # 1 MiB fp32 per rank for the checked calls
MH_NBC_ELEMS = 37              # nbc's ring rounds (under the fused round)
MH_CASES = ("allreduce SUM f32", "allreduce MAX f32", "allreduce SUM i32",
            "allreduce MINLOC", "bcast root 0", "allgather", "alltoall",
            "ring allreduce SUM f32", "bruck allgather",
            "nbc iallreduce SUM f32", "bucket 0", "bucket 1")
# the direct float sums fold each controller's rows, then the partials:
# not the single-controller comm's association (held to rtol 1e-5)
MH_ASSOCIATION = ("allreduce SUM f32", "bucket 0", "bucket 1")


def _mh_inputs(m: int) -> dict:
    """Every case's global input for an m-rank comm, from the seed."""
    rng = np.random.default_rng(MH_SEED + m)
    f = rng.standard_normal((m, MH_ELEMS)).astype(np.float32)
    val = rng.integers(0, 4, (m, MH_ELEMS // 2)).astype(np.float32)
    idx = np.broadcast_to(np.arange(m, dtype=np.float32)[:, None],
                          val.shape)
    small = [rng.standard_normal((m, MH_NBC_ELEMS + k)).astype(np.float32)
             for k in range(3)]
    return {"f32": f, "i32": (f * 1000).astype(np.int32),
            "pairs": np.ascontiguousarray(np.stack([val, idx], -1)),
            "wide": np.ascontiguousarray(
                f[:, :MH_ELEMS // m * m]).reshape(m, m, -1),
            "nbc": small[0], "bucket 0": small[1], "bucket 1": small[2]}


def _mh_calls(comm, xs: dict) -> dict:
    """Every case of phase 22 on ``comm`` (a spanning comm, or the
    single-controller oracle): {case: result}, plus the bucket's unfused
    twins."""
    x = {k: comm.put(v) for k, v in xs.items()}
    out = {"allreduce SUM f32": comm.allreduce(x["f32"], MPI.SUM),
           "allreduce MAX f32": comm.allreduce(x["f32"], MPI.MAX),
           "allreduce SUM i32": comm.allreduce(x["i32"], MPI.SUM),
           "allreduce MINLOC": comm.allreduce(x["pairs"], MPI.MINLOC),
           "bcast root 0": comm.bcast(x["f32"], 0),
           "allgather": comm.allgather(x["f32"]),
           "alltoall": comm.alltoall(x["wide"])}
    for case, func, alg in (("ring allreduce SUM f32", "allreduce", "ring"),
                            ("bruck allgather", "allgather", "bruck")):
        var.var_set(f"coll_torch_{func}_algorithm", alg)
        out[case] = (comm.allreduce(x["f32"], MPI.SUM) if func == "allreduce"
                     else comm.allgather(x["f32"]))
        var.var_set(f"coll_torch_{func}_algorithm", "auto")
    req = comm.iallreduce(x["nbc"], MPI.SUM)
    req.wait()
    out["nbc iallreduce SUM f32"] = req.get()
    var.var_set("mpi_base_bucket", True)
    reqs = [comm.iallreduce(x[f"bucket {k}"], MPI.SUM) for k in range(2)]
    MPI.Waitall(reqs)
    var.var_set("mpi_base_bucket", False)
    for k in range(2):
        out[f"bucket {k}"] = reqs[k].get()
        out[f"unfused {k}"] = comm.allreduce(x[f"bucket {k}"], MPI.SUM)
    return out


def _mh_numpy(case: str, xs: dict, m: int) -> np.ndarray:
    """The collectives row's numpy answer of one case (every rank's
    row)."""
    f64 = xs["f32"].astype(np.float64)
    if case in ("allreduce SUM f32", "ring allreduce SUM f32"):
        return np.broadcast_to(f64.sum(0), f64.shape)
    if case == "allreduce MAX f32":
        return np.broadcast_to(xs["f32"].max(0), f64.shape)
    if case == "allreduce SUM i32":
        return np.broadcast_to(xs["i32"].sum(0, dtype=np.int32),
                               xs["i32"].shape)
    if case == "allreduce MINLOC":
        v = xs["pairs"][..., 0]
        one = np.stack([v.min(0), np.argmin(v, 0).astype(np.float32)], -1)
        return np.broadcast_to(one, xs["pairs"].shape)
    if case == "bcast root 0":
        return np.broadcast_to(xs["f32"][0], f64.shape)
    if case in ("allgather", "bruck allgather"):
        return np.broadcast_to(xs["f32"], (m,) + xs["f32"].shape)
    if case == "alltoall":
        return np.swapaxes(xs["wide"], 0, 1)
    src = xs["nbc" if case.startswith("nbc") else case].astype(np.float64)
    return np.broadcast_to(src.sum(0), src.shape)


def _mh_check_comm(tag: str, c, dev, me: int) -> dict:
    """Phase 22's cases on one spanning comm of one controller, against
    the single-controller oracle and numpy; the gate and the staging
    decision of its tier."""
    from ompi_tpu_torch.core import multictl
    m, mine = c.size, list(c._local)
    xs = _mh_inputs(m)
    got = _mh_calls(c, xs)
    oracle = _sched_oracle(m, dev)
    want = _mh_calls(oracle, xs)
    bitwise, held = [], []
    for case in MH_CASES:
        a = got[case].local
        b = want[case][mine]
        check(a.device == dev and a.shape == b.shape, f"{tag} {case}: "
              f"{a.shape} on {a.device}")
        if case in MH_ASSOCIATION:
            _close(a.cpu().numpy(), b.cpu().numpy(), 1e-5, 1e-5,
                   f"controller {me} {tag} {case} against the oracle")
            held.append(case)
        else:
            check(_bits(a, b), f"controller {me} {tag} {case}: not the "
                               f"oracle's bits")
            bitwise.append(case)
        ref = np.ascontiguousarray(_mh_numpy(case, xs, m)[mine])
        host = a.cpu().numpy()
        if host.dtype.kind == "f" and ("SUM" in case or "bucket" in case):
            check(np.allclose(host, ref, rtol=1e-5, atol=1e-5),
                  f"controller {me} {tag} {case} differs from numpy")
        else:
            check(np.array_equal(host, ref.astype(host.dtype)),
                  f"controller {me} {tag} {case} differs from numpy")
    for k in range(2):
        check(_bits(got[f"bucket {k}"].local, got[f"unfused {k}"].local),
              f"controller {me} {tag}: bucket member {k} differs from its "
              f"unfused allreduce")
    oracle.free()
    t = multictl.tier(c.layout)
    return {"bitwise": bitwise, "held": held, "gate": t._slots_ok(),
            "slots": t._slots is not None,
            "staged_host": t._stageable(np.zeros(1 << 22, np.float32),
                                        MPI.SUM)}


def _mh_same_bits(s, dev, me: int) -> list:
    """On the split's tier (controllers 0 and 1, one host): every device
    body on its slots, then on the same inputs staged (the gate turned
    to "another host" on both), bit for bit."""
    from ompi_tpu_torch.core import multictl
    t = multictl.tier(s.layout)
    n, r = t.size, t.rank()
    rng = np.random.default_rng(MH_SEED + 100 + r)
    f = torch.from_numpy(rng.standard_normal(MH_ELEMS).astype(
        np.float32)).to(dev)
    pairs = torch.from_numpy(np.stack(
        [rng.integers(0, 4, MH_ELEMS // 2).astype(np.float32),
         np.full(MH_ELEMS // 2, r, np.float32)], -1)).to(dev)
    i32 = (f * 1000).to(torch.int32)
    chunks = list(f.view(n, -1).unbind(0))
    want = [(0, 0) if j == r else (j * 64, (j + 1) * 64 + r)
            for j in range(n)]
    give = [(0, 0) if j == r else (r * 64, (r + 1) * 64 + j)
            for j in range(n)]
    bodies = {
        "allreduce SUM f32": lambda: [t._device_allreduce(f, MPI.SUM)],
        "allreduce MAX f32": lambda: [t._device_allreduce(f, MPI.MAX)],
        "allreduce SUM i32": lambda: [t._device_allreduce(i32, MPI.SUM)],
        "allreduce MINLOC": lambda: [t._device_allreduce(pairs,
                                                         MPI.MINLOC)],
        "bcast": lambda: [t._device_bcast(f, 1)],
        "allgather": lambda: t._device_allgather(f),
        "alltoall": lambda: t._device_alltoall(chunks),
        "exchange": lambda: t._device_exchange(f, MH_ELEMS * 4, want,
                                               give)}
    same = []
    for name, body in bodies.items():
        slots = t._coll_serial(body)
        t._one_host = False
        try:
            staged = t._coll_serial(body)
        finally:
            t._one_host = True
        check(len(slots) == len(staged) and all(
            (a is None and b is None) or _bits(a, b)
            for a, b in zip(slots, staged)),
              f"controller {me}: the staged {name} differs from its slots")
        check(all(a is None or a.device == dev for a in staged),
              f"controller {me}: a staged {name} result off cuda:0")
        same.append(name)
    return same


def _multihost_rank(t_launch: float, shm_b: str, report: str) -> int:
    """One controller of phase 22 (run by ``mpirun --coordinator``).
    Controller 2 is host B: another host identity and shared-memory
    directory before ``Init``."""
    from ompi_tpu_torch.accelerator import framework
    from ompi_tpu_torch.btl import bml
    from ompi_tpu_torch.core import multictl, rankcomm
    from ompi_tpu_torch.core.rankcomm import chunk_bounds
    t0 = time.perf_counter()
    me = int(os.environ["OMPI_TPU_TORCH_MCA_mpi_base_process_id"])
    if MH_HOSTS[me]:
        ident = f"{bml._host_identity()}/host{MH_HOSTS[me]}"
        bml._host_identity = lambda: ident
        framework.SHM_DIR = shm_b
    dev = torch.device("cuda", 0)
    MPI.Init(devices=[dev] * MH_ROWS[me])
    up_s = time.time() - t_launch
    w = MPI.get_comm_world()
    n = w.size
    mine = list(w._local)
    check(n == sum(MH_ROWS) and w.spans_processes, f"world of {n} rows")
    colors = [MH_HOSTS[w.controller_of(r)] for r in range(n)]
    s = w.split(colors)[mine[0]]
    comms = [("world", w)] + ([("split", s)] if s.spans_processes else [])
    check(s.spans_processes == (MH_HOSTS[me] == 0), "the split's layout")
    fl0 = FA.launches
    nums = {"controller": me, "up_s": up_s, "comms": {}, "ms": {},
            "bytes": {}}
    for tag, c in comms:
        nums["comms"][tag] = _mh_check_comm(tag, c, dev, me)
    check(nums["comms"]["world"]["gate"] is False
          and not nums["comms"]["world"]["slots"]
          and nums["comms"]["world"]["staged_host"] is False,
          f"the world's tier: {nums['comms']['world']}")
    if "split" in nums["comms"]:
        check(nums["comms"]["split"]["gate"] is True
              and nums["comms"]["split"]["slots"],
              f"the split's tier: {nums['comms']['split']}")
        nums["same_bits"] = _mh_same_bits(s, dev, me)
    # the 32 MiB-per-rank allreduce SUM, staged (world) and on slots
    # (split): CUDA-event span with the host fences; tier bytes of one
    # call against what its steps owe; numpy
    rng = np.random.default_rng(MH_SEED)
    xs = rng.random((n, LOCAL_ELEMS), dtype=np.float32)
    nbytes = LOCAL_ELEMS * 4
    big = {}
    for tag, c in comms:
        ranks = list(c._local)
        # the split's ranks are world ranks 0-5, in order
        x = c.put(xs[:c.size])
        b0 = dict(rankcomm.tier_bytes)
        y = c.allreduce(x, MPI.SUM)
        moved = {k: rankcomm.tier_bytes[k] - b0[k] for k in b0}
        ref = xs[:c.size].astype(np.float64).sum(0)
        check(np.allclose(y.local[0].cpu().numpy(), ref, rtol=1e-5,
                          atol=1e-5) and all(
            torch.equal(y.local[a], y.local[0]) for a in range(len(ranks))),
              f"controller {me}: 32 MiB {tag} allreduce against numpy")
        del y
        lay = c.layout
        H, h = len(lay.parts), lay.h
        b = chunk_bounds(LOCAL_ELEMS, H)
        own = (b[h + 1] - b[h]) * 4
        owe = ({"out": nbytes - own + (H - 1) * own,
                "in": (H - 1) * own + nbytes - own} if tag == "world" else
               {"out": nbytes + own, "in": (H - 1) * own + nbytes - own})
        check(moved == owe, f"controller {me}: {tag} tier bytes {moved}, "
                            f"owed {owe}")
        nums["bytes"][tag] = (moved, owe)
        _, ms, us = _pr_timed(lambda c=c, x=x: c.allreduce(x, MPI.SUM),
                              iters=5)
        nums["ms"][tag] = (ms, us)
        big[tag] = (c, x, own)
    calls = {f"{tag} allreduce": (lambda c=c, x=x: c.allreduce(x, MPI.SUM))
             for tag, (c, x, _own) in big.items()}
    xw = big["world"][1]
    calls["control .cpu()"] = lambda: xw.local.cpu()
    dtoh = _dtoh_split(calls)
    for name, (cnt, nb) in dtoh.items():
        if name == "control .cpu()":
            check(cnt >= 1 and nb >= MH_ROWS[me] * nbytes,
                  f"the .cpu() control saw {cnt} DtoH records, {nb} bytes")
        elif name == "world allreduce":
            # staged: this controller's partial off the card, then its
            # folded chunk
            own = big["world"][2]
            check(cnt == 2 and nb == nbytes + own,
                  f"staged allreduce: {cnt} DtoH records, {nb} bytes, "
                  f"designed 2, {nbytes + own}")
        else:
            check(cnt == 0 or nb < nbytes,
                  f"{name}: {cnt} DtoH records, {nb} bytes")
    nums["dtoh"] = dtoh
    nums["flash_fold"] = FA.launches - fl0
    check(nums["flash_fold"] == 0, "a flash-fold launch in phase 22")
    nums["live"] = multictl.live()
    del big, calls, xw
    MPI.Finalize()
    nums["seconds"] = time.perf_counter() - t0
    with open(report, "w") as f:
        json.dump(nums, f)
    print(f"OK multihost controller={me}", flush=True)
    return 0


def phase_multihost(smi: str) -> int:
    """Launch the three controllers (host B emulated by controller 2),
    relay their numbers; returns the flash-fold launches (0)."""
    import signal
    import tempfile
    from ompi_tpu_torch.accelerator import SHM_DIR, tag_for
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    mpirun = os.path.join(root, "ompi_tpu_torch", "tools", "mpirun.py")
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        shm_b = os.path.join(tmp, "shm_host_b")
        os.makedirs(shm_b)
        reports = [os.path.join(tmp, f"c{h}.json")
                   for h in range(len(MH_ROWS))]
        t_launch = time.time()
        procs = [subprocess.Popen(
            [sys.executable, mpirun, "--coordinator", f"127.0.0.1:{port}",
             "--num-hosts", str(len(MH_ROWS)), "--host-id", str(h), "-n",
             str(rows), os.path.abspath(__file__), "--multihost-rank",
             repr(t_launch), shm_b, reports[h]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=root, start_new_session=True)
            for h, rows in enumerate(MH_ROWS)]
        deadline = time.monotonic() + MH_JOB_TIMEOUT
        outs = []
        for p in procs:
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                out, err = "", "killed at the phase's limit"
            outs.append((out, err))
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        job_s = time.perf_counter() - t0
        for h, (p, (out, err)) in enumerate(zip(procs, outs)):
            if p.returncode != 0 or f"OK multihost controller={h}" not in out:
                sys.stderr.write(err[-6000:])
                check(False, f"controller {h} rc={p.returncode}:\n"
                      f"{out[-3000:]}")
        nums = []
        for r in reports:
            with open(r) as f:
                nums.append(json.load(f))
        left_b = os.listdir(shm_b)
    tag = tag_for(f"127.0.0.1:{port}")
    left = [f for f in os.listdir(SHM_DIR)
            if f.startswith("otpt") and f"_{tag}_" in f] + left_b
    check(not left, f"files left behind: {left}")
    check(job_s <= MH_JOB_TIMEOUT, f"the job took {job_s:.1f} s")
    mib = LOCAL_ELEMS * 4 / 2 ** 20
    layout = "3 controllers x (4, 2, 2) rows on cuda:0, hosts A {0, 1}, B {2}"
    for c in nums:
        for tag, d in c["comms"].items():
            m = sum(MH_ROWS) if tag == "world" else MH_ROWS[0] + MH_ROWS[1]
            phase("multihost", f"controller {c['controller']} {tag} "
                  f"({'staged' if not d['gate'] else 'slots'}): "
                  f"{len(d['bitwise'])} cases bit for bit against the "
                  f"{m}-row single-controller comm on cuda:0 "
                  f"({', '.join(d['bitwise'])}); {', '.join(d['held'])} "
                  f"within rtol 1e-5 of it (the controllers' partials fold "
                  f"in another association) and the bucket = its unfused "
                  f"calls bit for bit; all = numpy as the collectives row; "
                  f"gate {d['gate']}, slots made {d['slots']}, a 16 MiB "
                  f"numpy buffer staged onto the tier {d['staged_host']}")
        if "same_bits" in c:
            phase("multihost", f"controller {c['controller']}: the staged "
                  f"bodies = the slot bodies bit for bit on the split's "
                  f"tier, 1 MiB per member, results on cuda:0: "
                  f"{', '.join(c['same_bits'])}")
    c0 = nums[0]
    for tag in ("world", "split"):
        ms, us = c0["ms"][tag]
        tier = ", ".join(
            f"c{c['controller']} {c['bytes'][tag][0]['out'] / 1e6:.3f}/"
            f"{c['bytes'][tag][0]['in'] / 1e6:.3f} MB (owed "
            f"{c['bytes'][tag][1]['out'] / 1e6:.3f}/"
            f"{c['bytes'][tag][1]['in'] / 1e6:.3f})"
            for c in nums if tag in c["bytes"])
        how = ("staged, 3 controllers on 2 hosts" if tag == "world"
               else "slots, controllers 0 and 1 on host A")
        phase("multihost", f"allreduce SUM f32 {mib:.0f} MiB per rank on "
              f"the {tag} ({how}): "
              f"{ms:.3f} ms call (controller 0, CUDA-event span with the "
              f"host fences), {us:.0f} us host; tier bytes out/in per "
              f"controller {tier} | {layout} | {smi}")
    for c in nums:
        d = c["dtoh"]
        phase("multihost", f"controller {c['controller']}: Memcpy DtoH "
              f"records (count, bytes) in one profiler session: "
              + "; ".join(f"{k} {tuple(v)}" for k, v in d.items())
              + f" (staged: the partial off the card, then the folded "
              f"chunk; slots: none of payload size); launch to Init done "
              f"{c['up_s']:.2f} s; flash-fold launches {c['flash_fold']}; "
              f"live tiers {c['live']['tiers']}")
    phase("multihost", f"phase 22 took {time.perf_counter() - t0:.1f} s "
          f"(limit {MH_JOB_TIMEOUT}; controllers "
          + ", ".join(f"{c['seconds']:.1f}" for c in nums)
          + f" s) | {smi}")
    return sum(c["flash_fold"] for c in nums)


def main() -> int:
    if "--multictl-rank" in sys.argv:
        return _multictl_rank(float(sys.argv[-2]), sys.argv[-1])
    if "--multihost-rank" in sys.argv:
        return _multihost_rank(float(sys.argv[-3]), sys.argv[-2],
                               sys.argv[-1])
    if "--perrank-rank" in sys.argv:
        return _perrank_rank(sys.argv[-1])
    if "--dataplane-rank" in sys.argv:
        return _dataplane_rank(sys.argv[-1])
    if "--observe-rank" in sys.argv:
        return _observe_rank(sys.argv[-1])
    if "--resilience-rank" in sys.argv:
        return _resilience_rank(sys.argv[-1])
    if "--bridge-rank" in sys.argv:
        return _bridge_rank(*sys.argv[-3:])
    if "--sessions-rank" in sys.argv:
        return _sessions_rank(sys.argv[-1])
    if "--fresh-check" in sys.argv:
        return _fresh_check(sys.argv[-1])
    if "--osc-rank" in sys.argv:
        return _osc_rank(sys.argv[-2].replace("_", " "), sys.argv[-1])
    if "--osc-fresh-check" in sys.argv:
        return _osc_fresh_check(sys.argv[-1])
    if "--planes-rank" in sys.argv:
        return _planes_rank(sys.argv[-1])
    if "--planes-fresh-check" in sys.argv:
        return _pln_fresh_check(sys.argv[-1])
    if "--tools-rank" in sys.argv:
        return _tools_rank(sys.argv[-2], sys.argv[-1])
    if "--tools-fresh-check" in sys.argv:
        return _tls_fresh_check(sys.argv[-1])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if "--resilience" in sys.argv:
        smi, _ = phase_device()
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        res_s = phase_resilience_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_resilience_job(smi, res_s)
        return 0
    if "--sessions" in sys.argv:
        smi, _ = phase_device()
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        ses_s = phase_sessions_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_sessions_job(smi, ses_s)
        return 0
    if "--onesided" in sys.argv:
        smi, _ = phase_device()
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        osc_s = phase_onesided_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_onesided_job(smi, osc_s)
        return 0
    if "--planes" in sys.argv:
        smi, _ = phase_device()
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        pln_s = phase_planes_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_planes_job(smi, pln_s)
        return 0
    if "--cabi" in sys.argv:
        smi, kind = phase_device()
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        cab = phase_cabi_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_cabi_job(smi, cab)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if "--algorithms" in sys.argv:
        smi, kind = phase_device()
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        phase_algorithms(MPI.get_comm_world(), smi)
        MPI.Finalize()
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if "--multictl" in sys.argv:
        smi, kind = phase_device()
        mc_launches = phase_multictl(smi)
        check(mc_launches == 0, "flash-fold launches in phase 20")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if "--multihost" in sys.argv:
        smi, kind = phase_device()
        mh_launches = phase_multihost(smi)
        check(mh_launches == 0, "flash-fold launches in phase 22")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if "--tools" in sys.argv:
        smi, kind = phase_device()
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        tls_s = phase_tools_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_tools_job(smi, tls_s)
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if "--bucketfold" in sys.argv:
        smi, kind = phase_device()
        phase_build()
        rec = phase_bucketfold()
        print(json.dumps({"kernels": [rec]}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}))
        return 0
    if "--perrank" in sys.argv:
        smi, _ = phase_device()
        phase_perrank(smi)
        MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
        _tuned_single(MPI.get_comm_world(), smi)
        world_s = phase_observe_world(MPI.get_comm_world(), smi)
        MPI.Finalize()
        torch.cuda.empty_cache()
        phase_dataplane(smi)
        phase_observe_job(smi, world_s)
        phase_resilience_job(smi, 0.0)
        return 0
    t0 = time.perf_counter()
    smi, kind = phase_device()
    phase_build()
    kern, checked = phase_kernels()
    bucket_rec = phase_bucketfold()
    MPI.Init(devices=[torch.device("cuda", 0)] * N_RANKS)
    world = MPI.get_comm_world()
    phase_collectives(world)
    launches = phase_flagship()
    phase_train(smi)
    t7 = time.perf_counter()
    phase_nonblocking_journey(world, smi)
    phase_ddp(world, smi)
    phase("nonblocking", f"phase 7 took {time.perf_counter() - t7:.1f} s "
          f"| {smi}")
    phase_algorithms(world, smi)
    phase_compression(world, smi)
    phase_ptp_topo_datatype(world, smi)
    _tuned_single(world, smi)
    world_s = phase_observe_world(world, smi)
    ses_s = phase_sessions_world(world, smi)
    osc_s = phase_onesided_world(world, smi)
    pln_s = phase_planes_world(world, smi)
    tls_s = phase_tools_world(world, smi)
    cab = phase_cabi_world(world, smi)
    res_s = phase_resilience_world(world, smi)
    MPI.Finalize()
    torch.cuda.empty_cache()
    phase_perrank(smi)
    phase_dataplane(smi)
    phase_observe_job(smi, world_s)
    phase_resilience_job(smi, res_s)
    phase_sessions_job(smi, ses_s)
    phase_onesided_job(smi, osc_s)
    phase_planes_job(smi, pln_s)
    phase_tools_job(smi, tls_s)
    cab_launches = phase_cabi_job(smi, cab)
    mc_launches = phase_multictl(smi)
    mh_launches = phase_multihost(smi)
    main = kern[("entry", "1")]        # the main path's fold
    record = {"kernels": [{
        "name": "flash_fold", "route": "cuda",
        "source": "ompi_tpu_torch/csrc/flash_fold.cu",
        "replaces": "ompi_tpu/ops/flash_attention.py:72",
        "launches": launches,
        "launches_cabi": cab_launches,     # phase 19, controller process
        "launches_multictl": mc_launches,  # phase 20, both controllers
        "launches_multihost": mh_launches,  # phase 22, three controllers
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")},
        "shapes": list(kern.values()),
        "checks": checked,
    }, bucket_rec]}
    phase("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
