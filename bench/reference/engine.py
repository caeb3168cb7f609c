"""The plain simulator: one batched tick of the tensor-timestepped engine
in PyTorch operations (a frozen copy of the port's `netsim/engine.py`
tick, without the fault masks, observers and windows, and with the plain
fused drain of `kernels/drain_tick.py`), run eagerly on the CPU and as
replays of its own captured graph on the card (``Simulator.run``).

One tick advances dt of virtual time for every member of a batch:
  1. rank VMs enter their (op, round) and emit messages (collectives
     expanded: ring / recursive doubling / binomial);
  2. injection: pool slots from a stack allocator, routes (MIN, or UGAL
     against the per-link demand of the pool before injection), latency
     floors;
  3. the fluid fair-share drain: the rate of a message is the least
     bandwidth share over its route, delivery at ``rem <= 1e-6``;
  4. bookkeeping: deliveries unblock VMs; latency histograms, router
     windows, link loads; the idle-time skip.

The link demand that UGAL compares is summed serially in flat (member,
slot, route slot) order, on the host (``numpy.add.at``): one differing
bit there can flip a route, and that order is the simulator's definition.
Every other float sum is a metric that nothing reads back, and integer
counts are exact in any order.

``fdt`` is the float type of the state; float32 is the simulator's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .fabric import Dragonfly, NetConfig
from .programs import OP, Program
from .routing import compute_routes, topo_arrays

MAXE = 8  # max emissions per rank per (op, round)
MASK32 = 0xFFFFFFFF


class JobTable(NamedTuple):
    ops: torch.Tensor  # (B, J, OPmax, 4) int32, END-padded
    grid: torch.Tensor  # (B, J, OPmax, 4) int32
    P: torch.Tensor  # (B, J) int32
    logp: torch.Tensor  # (B, J) int32 ceil(log2(max(P, 2)))
    r2n: torch.Tensor  # (B, J, Pmax) int32 rank -> node
    start: torch.Tensor  # (B, J) arrival offset


class VMState(NamedTuple):
    pc: torch.Tensor
    rnd: torch.Tensor
    emitted: torch.Tensor
    busy_until: torch.Tensor
    send_need: torch.Tensor
    send_done: torch.Tensor
    recv_need: torch.Tensor
    recv_done: torch.Tensor
    comm_time: torch.Tensor
    done: torch.Tensor


class URState(NamedTuple):
    next_t: torch.Tensor
    count: torch.Tensor


class PoolState(NamedTuple):
    active: torch.Tensor
    src_rank: torch.Tensor
    dst_rank: torch.Tensor
    job: torch.Tensor
    size: torch.Tensor
    bytes_rem: torch.Tensor
    inject_t: torch.Tensor
    min_arrive: torch.Tensor
    routes: torch.Tensor
    free_stack: torch.Tensor
    free_top: torch.Tensor
    dropped: torch.Tensor


class Metrics(NamedTuple):
    lat_hist: torch.Tensor
    lat_sum: torch.Tensor
    lat_min: torch.Tensor
    lat_max: torch.Tensor
    lat_cnt: torch.Tensor
    link_bytes: torch.Tensor
    router_win: torch.Tensor
    router_wins: torch.Tensor
    win_idx: torch.Tensor
    peak_inject: torch.Tensor


class SimState(NamedTuple):
    t: torch.Tensor  # (B,)
    vms: VMState
    ur: Optional[URState]
    pool: PoolState
    metrics: Metrics
    rng: torch.Tensor  # (B,) int64 holding a uint32
    jobs: JobTable
    ur_nodes: Optional[torch.Tensor]


def _hash(x):
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & MASK32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & MASK32
    return x ^ (x >> 16)


def _global_idx(target, idx):
    B = target.shape[0]
    size = target[0].numel()
    off = (torch.arange(B, device=idx.device) * size).reshape(
        (B,) + (1,) * (idx.dim() - 1))
    return idx.long() + off, B * size


def _flat_scatter(target, idx, vals, valid, accumulate):
    """Scatter into every member's leaf at once; ``valid=False`` entries
    go to one extra element that is sliced off."""
    gidx, n = _global_idx(target, idx)
    if isinstance(vals, torch.Tensor):
        vals = torch.broadcast_to(vals.to(target.dtype), idx.shape)
    else:
        vals = torch.full(idx.shape, vals, dtype=target.dtype,
                          device=target.device)
    vals = vals.reshape(-1)
    flat = target.reshape(-1)
    if valid is None:
        flat = flat.clone()
    else:
        gidx = torch.where(valid, gidx, n)
        flat = torch.cat([flat, flat.new_zeros(1)])
    gidx = gidx.reshape(-1)
    if accumulate:
        flat.index_add_(0, gidx, vals)
    else:
        flat.index_put_((gidx,), vals)
    return flat[:n].reshape(target.shape)


def _flat_add(target, idx, vals, valid=None):
    return _flat_scatter(target, idx, vals, valid, accumulate=True)


def _flat_set(target, idx, vals, valid=None):
    return _flat_scatter(target, idx, vals, valid, accumulate=False)


def _flat_reduce(target, idx, vals, how):
    gidx, _ = _global_idx(target, idx)
    return target.reshape(-1).clone().scatter_reduce_(
        0, gidx.reshape(-1), vals.reshape(-1), how).reshape(target.shape)


def link_demand(routes, active, bytes_rem, n_links: int):
    """(B, L+1) bytes outstanding on each link, each link's entries summed
    serially in flat (member, slot, route slot) order, in float32."""
    B, M, K = routes.shape
    Lp = n_links + 1
    valid = ((routes >= 0) & active[:, :, None]).reshape(-1)
    at = torch.nonzero(valid).reshape(-1)  # ascending: the flat order
    keys = (routes.reshape(-1)[at].long()
            + torch.div(at, M * K, rounding_mode="floor") * Lp)
    vals = bytes_rem[:, :, None].expand(B, M, K).reshape(-1)[at]
    out = np.zeros(B * Lp, np.float32)
    np.add.at(out, keys.cpu().numpy(), vals.float().cpu().numpy())
    return torch.as_tensor(out, device=routes.device).to(
        bytes_rem.dtype).reshape(B, Lp)


def drain(routes, bytes_rem, active, job, min_arrive, t, dt, bw_eff,
          link_dst_router, n_apps, n_routers):
    """The fused drain: messages per link -> fair share -> each message's
    rate (least share on its route) -> drain -> delivery, with the
    per-link and per-(app, destination router) byte counters. The counts
    of messages a link are whole numbers, exact in any order of adds; the
    byte counters are metrics."""
    B, M, K = routes.shape
    Lp = bw_eff.shape[-1]
    dev = routes.device
    fdt = bytes_rem.dtype
    valid = (routes >= 0) & active[:, :, None]
    # an empty route slot adds 0 to a link of its own (spread over the
    # links, so that the adds do not all wait on one address)
    spread = torch.arange(B * M * K, device=dev).reshape(B, M, K) % Lp
    lidx = torch.where(valid, routes.long(), spread)
    boff = (torch.arange(B, device=dev) * Lp)[:, None, None]
    flat = (lidx + boff).reshape(-1)
    n_l = torch.zeros(B * Lp, dtype=fdt, device=dev).index_add_(
        0, flat, valid.reshape(-1).to(fdt))
    share = bw_eff.expand(B, Lp) / torch.clamp(
        n_l.reshape(B, Lp), min=1.0) * 1e-6
    inf = torch.full((), float("inf"), dtype=fdt, device=dev)
    per_link = torch.where(
        valid, share.reshape(-1)[flat].reshape(B, M, K), inf)
    rate = per_link.amin(dim=2)
    rate = torch.where(active & torch.isfinite(rate), rate, 0.0)
    drained = torch.minimum(rate * dt, bytes_rem)
    new_rem = bytes_rem - drained
    drain_b = torch.where(valid, drained[:, :, None], 0.0)
    link_bytes_delta = torch.zeros(B * Lp, dtype=fdt, device=dev).index_add_(
        0, flat, drain_b.reshape(-1)).reshape(B, Lp)
    rtr = link_dst_router.long()[lidx]
    rw_flat = (job.long()[:, :, None] * n_routers + rtr
               + (torch.arange(B, device=dev)
                  * n_apps * n_routers)[:, None, None])
    router_win_delta = torch.zeros(
        B * n_apps * n_routers, dtype=fdt, device=dev).index_add_(
        0, rw_flat.reshape(-1), drain_b.reshape(-1),
    ).reshape(B, n_apps, n_routers)
    delivered = active & (new_rem <= 1e-6) & (t[:, None] >= min_arrive)
    return new_rem, delivered, link_bytes_delta, router_win_delta


class Simulator:
    """The engine for one scenario's job set (``Jmax`` jobs of at most
    ``Pmax`` ranks and ``OPmax`` ops) on ``topo``, batched over members."""

    def __init__(self, topo: Dragonfly, programs: Sequence[Program], *,
                 routing: str, net: NetConfig, pool_size: int,
                 horizon_us: float, start_us: Sequence[float],
                 ur: Optional[dict], device, fdt=torch.float32):
        self.topo, self.programs, self.net = topo, list(programs), net
        self.dev = torch.device(device)
        self.fdt = fdt
        self.M = pool_size
        self.horizon_us = horizon_us
        self.start_us = [float(x) for x in start_us]
        self.ur = ur  # {"ranks", "size_bytes", "interval_us", "start_us"}
        self.J = len(self.programs)
        self.Pmax = max(p.n_ranks for p in self.programs)
        self.OPmax = max(p.n_ops for p in self.programs)
        self.n_apps = self.J + (1 if ur else 0)
        self.adaptive = routing.upper() in ("ADP", "ADAPTIVE")
        self.T = topo_arrays(topo, self.dev)
        self.L = topo.n_links
        self.R = topo.n_routers
        self.dt = float(np.float32(net.tick_us))
        dev = self.dev
        self.link_dstr = torch.as_tensor(np.concatenate(
            [np.asarray(topo.link_dst_router, np.int32),
             np.zeros(1, np.int32)]), device=dev)
        self.bw = torch.cat([
            torch.as_tensor(np.asarray(topo.link_bw, np.float32),
                            device=dev),
            torch.ones(1, dtype=torch.float32, device=dev)]).to(fdt)
        J, Pmax = self.J, self.Pmax
        self.N = J * Pmax * MAXE
        self.cand_job = torch.as_tensor(
            np.repeat(np.arange(J, dtype=np.int64), Pmax * MAXE), device=dev)
        self.cand_rank = torch.as_tensor(np.tile(
            np.repeat(np.arange(Pmax, dtype=np.int64), MAXE), J), device=dev)
        self.cand_local = torch.as_tensor(
            np.tile(np.arange(Pmax * MAXE, dtype=np.int64), J), device=dev)

    # -- initial state --------------------------------------------------
    def init_state(self, placements: Sequence[np.ndarray],
                   seeds: Sequence[int]) -> SimState:
        """The batch of members: ``placements[b]`` holds member b's node
        arrays (each job's, then the UR source's), ``seeds[b]`` its engine
        rng seed."""
        B, J, Pmax, OPmax = len(seeds), self.J, self.Pmax, self.OPmax
        dev, fdt, M, L = self.dev, self.fdt, self.M, self.L
        ops = np.zeros((J, OPmax, 4), np.int32)
        ops[:, :, 0] = OP["END"]
        grid = np.zeros((J, OPmax, 4), np.int32)
        P = np.ones((J,), np.int32)
        for ji, pr in enumerate(self.programs):
            ops[ji, :pr.n_ops] = pr.ops
            grid[ji, :pr.n_ops] = pr.grid
            P[ji] = pr.n_ranks
        logp = np.asarray([max(1, math.ceil(math.log2(max(int(p), 2))))
                           for p in P], np.int32)
        r2n = np.zeros((B, J, Pmax), np.int32)
        for b, pl in enumerate(placements):
            for ji, pr in enumerate(self.programs):
                r2n[b, ji, :pr.n_ranks] = np.asarray(pl[ji], np.int32)
        start = np.asarray(self.start_us, np.float32)
        done0 = ((np.arange(Pmax)[None, :] >= P[:, None])
                 | (ops[:, 0, 0] == OP["END"])[:, None])

        def rep(x):
            return torch.as_tensor(
                np.broadcast_to(x, (B,) + x.shape).copy(), device=dev)

        def z(dtype=torch.int32):
            return torch.zeros((B, J, Pmax), dtype=dtype, device=dev)

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        jobs = JobTable(ops=rep(ops), grid=rep(grid), P=rep(P),
                        logp=rep(logp), r2n=torch.as_tensor(r2n, device=dev),
                        start=rep(start).to(fdt))
        vms = VMState(pc=z(), rnd=z(), emitted=z(torch.bool),
                      busy_until=z(fdt), send_need=z(), send_done=z(),
                      recv_need=z(), recv_done=z(), comm_time=z(fdt),
                      done=rep(done0))
        ur_state = ur_nodes = None
        if self.ur is not None:
            Pu = int(self.ur["ranks"])
            ur_state = URState(
                next_t=full((B, Pu), float(self.ur["start_us"]), fdt),
                count=full((B, Pu), 0, torch.int32))
            ur_nodes = torch.as_tensor(np.stack(
                [np.asarray(pl[J], np.int32) for pl in placements]),
                device=dev)
        i32 = torch.int32
        pool = PoolState(
            active=full((B, M), False, torch.bool),
            src_rank=full((B, M), 0, i32), dst_rank=full((B, M), 0, i32),
            job=full((B, M), 0, i32), size=full((B, M), 0, fdt),
            bytes_rem=full((B, M), 0, fdt), inject_t=full((B, M), 0, fdt),
            min_arrive=full((B, M), 0, fdt),
            routes=full((B, M, self.topo.route_width), -1, i32),
            free_stack=torch.arange(M, dtype=i32, device=dev).repeat(B, 1),
            free_top=full((B,), M, i32), dropped=full((B,), 0, i32))
        na, W, BINS = self.n_apps, self.net.max_windows, \
            self.net.latency_hist_bins
        metrics = Metrics(
            lat_hist=full((B, na, BINS), 0, i32),
            lat_sum=full((B, na), 0, fdt),
            lat_min=full((B, na), math.inf, fdt),
            lat_max=full((B, na), -math.inf, fdt),
            lat_cnt=full((B, na), 0, i32),
            link_bytes=full((B, L + 1), 0, fdt),
            router_win=full((B, na, self.R), 0, fdt),
            router_wins=full((B, W, na, self.R), 0, fdt),
            win_idx=full((B,), 0, i32), peak_inject=full((B,), 0.0, fdt))
        rng = torch.as_tensor([int(s) & MASK32 for s in seeds],
                              dtype=torch.int64, device=dev)
        return SimState(t=full((B,), 0.0, fdt), vms=vms, ur=ur_state,
                        pool=pool, metrics=metrics, rng=rng, jobs=jobs,
                        ur_nodes=ur_nodes)

    # -- the tick ---------------------------------------------------------
    def live(self, s: SimState) -> torch.Tensor:
        done = s.vms.done.flatten(-2).all(-1) & ~s.pool.active.any(-1)
        return (s.t < self.horizon_us) & ~done

    def _gather_op(self, table, pc):
        return torch.gather(table, 2, pc.long()[..., None].expand(
            -1, -1, -1, 4))

    def _vm_emit(self, jt: JobTable, vm: VMState, t, live_m):
        dev, fdt, i32 = self.dev, self.fdt, torch.int32
        B, J, Pmax = t.shape[0], self.J, self.Pmax
        ranks = torch.arange(Pmax, dtype=i32, device=dev)[None, None, :]
        emit_slots = torch.arange(MAXE, dtype=i32, device=dev)
        P = jt.P[:, :, None]
        row = self._gather_op(jt.ops, vm.pc)
        opc, a0, a1, a2 = row[..., 0], row[..., 1], row[..., 2], row[..., 3]
        g = self._gather_op(jt.grid, vm.pc)
        enter = ((~vm.emitted) & (~vm.done)
                 & (t[:, None, None] >= jt.start[:, :, None])
                 & live_m[:, None, None])
        dst = torch.full((B, J, Pmax, MAXE), -1, dtype=i32, device=dev)
        size = torch.zeros((B, J, Pmax), dtype=fdt, device=dev)
        send_inc = torch.zeros((B, J, Pmax), dtype=i32, device=dev)
        recv_inc = torch.zeros((B, J, Pmax), dtype=i32, device=dev)
        # COMPUTE: the rank is busy for a0 us
        is_comp = opc == OP["COMPUTE"]
        busy = torch.where(enter & is_comp, t[:, None, None] + a0.to(fdt),
                           vm.busy_until)
        # P2P / IP2P
        is_p2p = (opc == OP["P2P"]) | (opc == OP["IP2P"])
        send_p2p = is_p2p & (ranks == a0)
        dst[..., 0] = torch.where(send_p2p, a1, dst[..., 0])
        size = torch.where(send_p2p, a2.to(fdt), size)
        send_inc = send_inc + send_p2p.to(i32)
        recv_inc = recv_inc + (is_p2p & (ranks == a1)).to(i32)
        # GATHER (root a0, size a1)
        is_gather = opc == OP["GATHER"]
        send_g = is_gather & (ranks != a0)
        dst[..., 0] = torch.where(send_g, a0, dst[..., 0])
        size = torch.where(send_g, a1.to(fdt), size)
        send_inc = send_inc + send_g.to(i32)
        recv_inc = recv_inc + torch.where(is_gather & (ranks == a0), P - 1, 0)
        # SCATTER (root a0, size a1), MAXE targets a round
        is_scat = opc == OP["SCATTER"]
        tgt = (vm.rnd * MAXE)[..., None] + emit_slots
        tgt = tgt + (tgt >= a0[..., None]).to(i32)  # skip the root
        valid_s = (is_scat[..., None] & (ranks == a0)[..., None]
                   & (tgt < P[..., None]))
        dst = torch.where(valid_s, tgt, dst)
        size = torch.where(is_scat & (ranks == a0), a1.to(fdt), size)
        send_inc = send_inc + torch.where(
            is_scat & (ranks == a0), valid_s.sum(-1).to(i32), 0)
        recv_inc = recv_inc + (is_scat & (ranks != a0)
                               & (vm.rnd == 0)).to(i32)
        # XCHG (size a0, ndims a1, dims g): one round, 2*ndims neighbours
        is_x = opc == OP["XCHG"]
        dims = g.clamp(min=1)
        stride = torch.cat([torch.ones_like(dims[..., :1]),
                            torch.cumprod(dims[..., :3], dim=-1)], dim=-1)
        coord = torch.remainder(
            torch.div(ranks[..., None], stride, rounding_mode="floor"), dims)
        for d in range(4):
            for s, dirn in ((2 * d, 1), (2 * d + 1, -1)):
                if s >= MAXE:
                    continue
                nb_c = torch.remainder(coord[..., d] + dirn, dims[..., d])
                nb = ranks + (nb_c - coord[..., d]) * stride[..., d]
                dst[..., s] = torch.where(is_x & (a1 > d), nb, dst[..., s])
        size = torch.where(is_x, a0.to(fdt), size)
        nmsg = 2 * torch.clamp(a1, max=4)
        send_inc = send_inc + torch.where(is_x, nmsg, 0)
        recv_inc = recv_inc + torch.where(is_x, nmsg, 0)
        # ALLREDUCE: ring (>= 4 KiB) of 2(P-1) rounds of size/P, else
        # recursive doubling; BARRIER: recursive doubling of 8 bytes
        is_ar = opc == OP["ALLREDUCE"]
        is_bar = opc == OP["BARRIER"]
        big = a0 >= 4096
        ring = is_ar & big
        dst[..., 0] = torch.where(ring, torch.remainder(ranks + 1, P),
                                  dst[..., 0])
        size = torch.where(ring, torch.ceil(a0.to(fdt) / P), size)
        send_inc = send_inc + ring.to(i32)
        recv_inc = recv_inc + ring.to(i32)
        rd = (is_ar & ~big) | is_bar
        pow2 = torch.ones_like(vm.rnd) << vm.rnd.clamp(max=30)
        peer = ranks ^ pow2
        rd_ok = rd & (peer < P)
        dst[..., 0] = torch.where(rd_ok, peer, dst[..., 0])
        size = torch.where(rd_ok, torch.clamp(a0.to(fdt), min=8.0), size)
        send_inc = send_inc + rd_ok.to(i32)
        recv_inc = recv_inc + rd_ok.to(i32)
        # BCAST (root a0, size a1): binomial over relative ranks
        is_bc = opc == OP["BCAST"]
        rel = torch.remainder(ranks - a0, P)
        bc_send = is_bc & (rel < pow2) & (rel + pow2 < P)
        dst[..., 0] = torch.where(bc_send, torch.remainder(rel + pow2 + a0, P),
                                  dst[..., 0])
        size = torch.where(bc_send, a1.to(fdt), size)
        send_inc = send_inc + bc_send.to(i32)
        recv_inc = recv_inc + (is_bc & (rel >= pow2)
                               & (rel < 2 * pow2)).to(i32)
        dst = torch.where(enter[..., None], dst, -1)
        vm = vm._replace(
            emitted=vm.emitted | enter, busy_until=busy,
            send_need=vm.send_need + torch.where(enter, send_inc, 0),
            recv_need=vm.recv_need + torch.where(enter, recv_inc, 0))
        return vm, dst, size

    def _inject(self, pool: PoolState, metrics: Metrics, t, src_ranks,
                dst_ranks, dsts_node, srcs_node, sizes, app_id, rand,
                demand, per_job_peak: bool):
        dev, fdt, M, L = self.dev, self.fdt, self.M, self.L
        i32 = torch.int32
        B, n = dst_ranks.shape
        mask = dst_ranks >= 0
        k = torch.cumsum(mask.to(i32), dim=1) - 1
        n_emit = mask.sum(dim=1).to(i32)
        can = (k < pool.free_top[:, None]) & mask
        slot_pos = (pool.free_top[:, None] - 1 - k).clamp(0, M - 1)
        slot = torch.gather(pool.free_stack, 1, slot_pos.long())
        slot = torch.where(can, slot, M)
        offs = torch.arange(B, device=dev).repeat_interleave(n) * (L + 1)
        routes, hops = compute_routes(
            self.T, srcs_node.reshape(-1), dsts_node.reshape(-1),
            rand.reshape(-1) & 0x7FFFFFFF, demand.reshape(-1),
            self.adaptive, demand_offsets=offs)
        routes = routes.reshape(B, n, -1)
        hops = hops.reshape(B, n)
        RW = self.topo.route_width
        row_idx = slot.long() + (torch.arange(B, device=dev) * M)[:, None]
        row_idx = torch.where(can, row_idx, B * M)
        rts = torch.cat([pool.routes.reshape(B * M, -1),
                         pool.routes.new_full((1, RW), -1)])
        rts.index_put_((row_idx.reshape(-1),), routes.reshape(B * n, -1))
        n_alloc = torch.minimum(n_emit, pool.free_top)
        pool = pool._replace(
            active=_flat_set(pool.active, slot, True, valid=can),
            src_rank=_flat_set(pool.src_rank, slot, src_ranks, valid=can),
            dst_rank=_flat_set(pool.dst_rank, slot, dst_ranks, valid=can),
            job=_flat_set(pool.job, slot, app_id, valid=can),
            size=_flat_set(pool.size, slot, sizes, valid=can),
            bytes_rem=_flat_set(pool.bytes_rem, slot, sizes, valid=can),
            inject_t=_flat_set(pool.inject_t, slot, t[:, None], valid=can),
            min_arrive=_flat_set(
                pool.min_arrive, slot,
                t[:, None] + hops.to(fdt) * self.net.hop_latency_us,
                valid=can),
            routes=rts[: B * M].reshape(pool.routes.shape),
            free_top=pool.free_top - n_alloc,
            dropped=pool.dropped + (n_emit - n_alloc))
        zero = torch.zeros((), dtype=fdt, device=dev)
        inj_bytes = torch.where(can, sizes, zero)
        if per_job_peak:
            peak = inj_bytes.reshape(B, self.J, -1).sum(dim=2).amax(dim=1)
        else:
            peak = inj_bytes.sum(dim=1)
        metrics = metrics._replace(
            peak_inject=torch.maximum(metrics.peak_inject, peak))
        return pool, metrics

    @staticmethod
    def _n_rounds(opc, a0, P, logp):
        big = a0 >= 4096
        return torch.where(
            opc == OP["ALLREDUCE"], torch.where(big, 2 * (P - 1), logp),
            torch.where(
                (opc == OP["BCAST"]) | (opc == OP["BARRIER"]), logp,
                torch.where(opc == OP["SCATTER"],
                            torch.div(P - 2, MAXE, rounding_mode="floor")
                            + 1, 1)))

    def tick(self, state: SimState, demand=None) -> SimState:
        """One tick of every member; ``demand`` is the per-link demand of
        ``state``'s pool (``link_demand``), worked out here when not
        given."""
        dev, fdt, net = self.dev, self.fdt, self.net
        i32, i64 = torch.int32, torch.int64
        J, Pmax, N, M, L = self.J, self.Pmax, self.N, self.M, self.L
        dt = self.dt
        BINS, W = net.latency_hist_bins, net.max_windows
        jt, t = state.jobs, state.t
        B = t.shape[0]
        pool, metrics, rng = state.pool, state.metrics, state.rng
        live_m = self.live(state)
        zero_f = torch.zeros((), dtype=fdt, device=dev)
        inf_f = torch.full((), math.inf, dtype=fdt, device=dev)

        # 1. VM entry + emission + injection
        vms, dst, sizes = self._vm_emit(jt, state.vms, t, live_m)
        fired = (dst >= 0).flatten(2).any(2)
        adv = (jt.P.to(i64) * MAXE) * fired.to(i64)
        base = (rng[:, None] + torch.cumsum(adv, dim=1) - adv) & MASK32
        rng_jobs = (rng + adv.sum(dim=1)) & MASK32
        dst_f = dst.reshape(B, N)
        sizes_f = sizes[:, :, :, None].expand(B, J, Pmax, MAXE).reshape(B, N)
        r2n_f = jt.r2n.reshape(B, J * Pmax)
        srcs_node = r2n_f[:, self.cand_job * Pmax + self.cand_rank]
        dsts_node = torch.gather(
            r2n_f, 1, self.cand_job[None, :] * Pmax + dst_f.clamp(min=0))
        rand = _hash((base[:, self.cand_job] + self.cand_local[None, :])
                     & MASK32)
        ur_state, rng2 = state.ur, rng_jobs
        if ur_state is not None:
            Pu = int(self.ur["ranks"])
            fire = (t[:, None] >= ur_state.next_t) & live_m[:, None]
            pu_ids = torch.arange(Pu, dtype=i64, device=dev)[None, :]
            rnd = _hash((ur_state.count.to(i64) * 9781 + pu_ids
                         + rng_jobs[:, None]) & MASK32)
            dstn = (rnd % self.topo.n_nodes).to(i32)
            ur_rand = _hash((rng_jobs[:, None] + pu_ids) & MASK32)
        # UGAL routes against the pool before injection
        if demand is None:
            demand = link_demand(pool.routes, pool.active, pool.bytes_rem, L)
        pool, metrics = self._inject(
            pool, metrics, t, self.cand_rank.to(i32).expand(B, N), dst_f,
            dsts_node, srcs_node, sizes_f, self.cand_job.to(i32).expand(B, N),
            rand, demand, per_job_peak=True)
        if ur_state is not None:
            pool, metrics = self._inject(
                pool, metrics, t,
                torch.arange(Pu, dtype=i32, device=dev).expand(B, Pu),
                torch.where(fire, 0, -1).to(i32), dstn, state.ur_nodes,
                torch.full((B, Pu), float(self.ur["size_bytes"]), dtype=fdt,
                           device=dev),
                torch.full((B, Pu), J, dtype=i32, device=dev), ur_rand,
                demand, per_job_peak=False)
            rng2 = (rng_jobs + Pu * fire.any(dim=1).to(i64)) & MASK32
            ur_state = URState(
                next_t=torch.where(fire, ur_state.next_t
                                   + float(self.ur["interval_us"]),
                                   ur_state.next_t),
                count=ur_state.count + fire.to(i32))

        # 2-3. drain and delivery
        new_rem, delivered, lb_delta, rw_delta = drain(
            pool.routes, pool.bytes_rem, pool.active, pool.job,
            pool.min_arrive, t, dt, self.bw, self.link_dstr,
            n_apps=self.n_apps, n_routers=self.R)
        new_rem = torch.where(live_m[:, None], new_rem, pool.bytes_rem)
        delivered = delivered & live_m[:, None]
        link_bytes = metrics.link_bytes + lb_delta * live_m[:, None]
        router_win = metrics.router_win + rw_delta * live_m[:, None, None]

        # latency metrics
        lat = (t[:, None] + dt) - pool.inject_t
        bins = torch.clamp(
            torch.log(torch.clamp(lat / net.latency_hist_lo_us, min=1e-6))
            / math.log(net.latency_hist_ratio), 0, BINS - 1).to(i32)
        app_of = pool.job
        d32 = delivered.to(i32)
        lat_hist = _flat_add(
            metrics.lat_hist, torch.where(delivered, app_of, 0) * BINS
            + torch.where(delivered, bins, 0), d32)
        lat_sum = _flat_add(metrics.lat_sum, app_of,
                            torch.where(delivered, lat, zero_f))
        lat_cnt = _flat_add(metrics.lat_cnt, app_of, d32)
        lat_min = _flat_reduce(metrics.lat_min, app_of,
                               torch.where(delivered, lat, inf_f), "amin")
        lat_max = _flat_reduce(metrics.lat_max, app_of,
                               torch.where(delivered, lat, -inf_f), "amax")

        # 4. deliveries -> VMs (UR's app id J is dropped)
        notify = delivered & (pool.job < J)
        vms = vms._replace(
            send_done=_flat_add(vms.send_done,
                                pool.job * Pmax + pool.src_rank,
                                notify.to(i32), valid=notify),
            recv_done=_flat_add(vms.recv_done,
                                pool.job * Pmax + pool.dst_rank,
                                notify.to(i32), valid=notify))
        kf = torch.cumsum(delivered.to(i32), dim=1) - 1
        free_stack = _flat_set(
            pool.free_stack, pool.free_top[:, None] + kf,
            torch.arange(M, dtype=i32, device=dev).expand(B, M),
            valid=delivered)
        pool = pool._replace(
            active=pool.active & ~delivered, bytes_rem=new_rem,
            free_stack=free_stack,
            free_top=pool.free_top + delivered.sum(dim=1).to(i32))

        # 5. VM completion / advance
        row = self._gather_op(jt.ops, vms.pc)
        opc, a0 = row[..., 0], row[..., 1]
        nr = self._n_rounds(opc, a0, jt.P[:, :, None], jt.logp[:, :, None])
        tdt = t[:, None, None] + dt
        ready = vms.emitted & ~vms.done & (tdt >= vms.busy_until)
        sat = ((vms.send_done >= vms.send_need)
               & (vms.recv_done >= vms.recv_need))
        nonblock = ((opc == OP["IP2P"]) | (opc == OP["LOG"])
                    | (opc == OP["RESET"]) | (opc == OP["COMPUTE"]))
        complete = ready & (sat | nonblock) & live_m[:, None, None]
        is_comm = ~((opc == OP["COMPUTE"]) | (opc == OP["LOG"])
                    | (opc == OP["RESET"]) | (opc == OP["END"]))
        blocked = (vms.emitted & ~vms.done & ~complete
                   & (tdt >= vms.busy_until) & is_comm
                   & live_m[:, None, None])
        dt_f = torch.full((), dt, dtype=fdt, device=dev)
        comm_time = vms.comm_time + torch.where(blocked, dt_f, zero_f)
        rnd2 = torch.where(complete, vms.rnd + 1, vms.rnd)
        advance = complete & (rnd2 >= nr)
        pc2 = torch.where(advance, vms.pc + 1, vms.pc)
        rnd2 = torch.where(advance, 0, rnd2)
        done2 = vms.done | (self._gather_op(jt.ops, pc2)[..., 0]
                            == OP["END"])
        vms = vms._replace(pc=pc2, rnd=rnd2, emitted=vms.emitted & ~complete,
                           done=done2, comm_time=comm_time)

        # 6. router-window rotation
        win_t = torch.floor((t + dt) / net.window_us).to(i32)
        rotate = (win_t > metrics.win_idx) & live_m
        wi = torch.clamp(metrics.win_idx, max=W - 1)
        hit = rotate[:, None] & (torch.arange(W, dtype=i32, device=dev)[
            None, :] == wi[:, None])
        router_wins = torch.where(hit[:, :, None, None], router_win[:, None],
                                  metrics.router_wins)
        router_win = torch.where(rotate[:, None, None], zero_f, router_win)
        win_idx = metrics.win_idx + rotate.to(i32)
        metrics = metrics._replace(
            lat_hist=lat_hist, lat_sum=lat_sum, lat_cnt=lat_cnt,
            lat_min=lat_min, lat_max=lat_max, link_bytes=link_bytes,
            router_win=router_win, router_wins=router_wins, win_idx=win_idx)

        # 7. idle-time skip: with the network empty and every live rank in
        # a COMPUTE delay or not yet arrived, jump to the earliest wake-up
        # (at most to the next metrics window)
        any_active = pool.active.any(dim=1)
        started = t[:, None] >= jt.start
        live_r = ~vms.done
        can_act = ((started[:, :, None] & live_r & ~vms.emitted)
                   .flatten(1).any(1)
                   | (live_r & vms.emitted & (vms.busy_until <= tdt))
                   .flatten(1).any(1))
        waiting = live_r & vms.emitted & (vms.busy_until > tdt)
        min_busy = torch.where(waiting, vms.busy_until, inf_f).flatten(1) \
            .amin(dim=1)
        pend = ~started & live_r.any(dim=2)
        min_busy = torch.minimum(
            min_busy, torch.where(pend, jt.start, inf_f).amin(dim=1))
        if ur_state is not None:
            min_busy = torch.minimum(min_busy, ur_state.next_t.amin(dim=1))
        next_window = (win_idx.to(fdt) + 1.0) * net.window_us
        skip_to = torch.minimum(min_busy, next_window)
        idle = ~any_active & ~can_act & torch.isfinite(skip_to)
        t_new = torch.where(idle, torch.maximum(t + dt, skip_to), t + dt)
        return SimState(
            t=torch.where(live_m, t_new, t), vms=vms, ur=ur_state, pool=pool,
            metrics=metrics,
            rng=torch.where(live_m, (rng2 + 1) & MASK32, rng),
            jobs=jt, ur_nodes=state.ur_nodes)

    def run(self, state: SimState, max_ticks: Optional[int] = None):
        """Tick until no member is live, or ``max_ticks`` ticks (a state
        in a float type too coarse to reach the horizon stops there);
        returns the final state and the ticks taken. On the card each
        tick is one replay of a captured graph of the tick, its link
        demand summed on the host between replays."""
        if max_ticks is None:
            max_ticks = 2 * int(math.ceil(self.horizon_us / self.dt)) + 64
        if self.dev.type == "cuda":
            return self._run_graphed(state, max_ticks)
        n = 0
        while n < max_ticks and bool(self.live(state).any()):
            state = self.tick(state)
            n += 1
        return state, n

    def _run_graphed(self, state: SimState, max_ticks: int):
        """The ticks as replays of one CUDA graph over static buffers: the
        tick from the buffers' state and the demand buffer, the state
        copied back, then the next tick's demand entries (valid route
        entries in flat order, packed by a prefix sum), their count and
        whether a member is live. The host reads those, sums the demand
        serially and writes it into the demand buffer."""
        B, M = state.t.shape[0], self.M
        K, Lp = self.topo.route_width, self.L + 1
        dev = self.dev
        leaves = _leaves(state)
        static = _rebuild(state, [x.clone() for x in leaves])
        demand = torch.zeros((B, Lp), dtype=self.fdt, device=dev)
        keys = torch.zeros(B * M * K + 1, dtype=torch.int64, device=dev)
        vals = torch.zeros(B * M * K + 1, dtype=self.fdt, device=dev)
        flags = torch.zeros(2, dtype=torch.int64, device=dev)
        boff = (torch.arange(B, device=dev) * Lp)[:, None, None]

        def step():
            out = self.tick(static, demand)
            for dst, src in zip(_leaves(static), _leaves(out)):
                dst.copy_(src)
            p = static.pool
            valid = ((p.routes >= 0) & p.active[:, :, None]).reshape(-1)
            at = torch.where(valid, torch.cumsum(valid, 0) - 1, B * M * K)
            keys.index_put_((at,), (p.routes.long() + boff).reshape(-1))
            vals.index_put_((at,), p.bytes_rem[:, :, None].expand(
                B, M, K).reshape(-1))
            flags[0] = valid.sum()
            flags[1] = self.live(static).any()

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.tick(static, demand)  # builds what the tick calls
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            step()
        for dst, src in zip(_leaves(static), leaves):
            dst.copy_(src)
        demand.copy_(link_demand(state.pool.routes, state.pool.active,
                                 state.pool.bytes_rem, self.L))
        n = 0
        live = bool(self.live(state).any())
        while n < max_ticks and live:
            graph.replay()
            n += 1
            count, live = flags.tolist()
            out = np.zeros(B * Lp, np.float32)
            np.add.at(out, keys[:count].cpu().numpy(),
                      vals[:count].float().cpu().numpy())
            demand.copy_(torch.as_tensor(out.reshape(B, Lp)))
        return _rebuild(static, [x.clone() for x in _leaves(static)]), n


def _leaves(tree):
    """The tensor leaves of nested NamedTuples, in field order."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for sub in tree for x in _leaves(sub)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its tensor leaves taken in order from ``leaves``."""
    it = iter(leaves)

    def go(t):
        if t is None:
            return None
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[go(x) for x in t])
        return next(it)

    return go(tree)
