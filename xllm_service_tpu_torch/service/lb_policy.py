"""Load-balance policies: RoundRobin / CacheAwareRouting / SloAware.

A copy of the JAX package's ``service/lb_policy.py``: the same behaviour
and names, importing only this package (and no device code).

Rebuild of ``scheduler/loadbalance_policy/`` (SURVEY.md §2 #9-11). Each
policy picks a (prefill, decode) instance pair for one tokenized request.
Unlike the reference — whose ``schedule()`` bypasses the pluggable policy
(scheduler.cpp:100-119, TODO at :102; SURVEY.md §7.4) — the scheduler here
actually routes through the configured policy.

Explainability: ``select_instances_pair`` takes an optional ``audit``
dict and fills it with the decision's evidence — which candidates were
considered, each candidate's score terms (match ratio / KV usage /
waiting ratio for cache-aware routing), the winner per role, and the
fallback reason when the scored pick was discarded. The scheduler
attaches the audit to the request's span (``attrs.schedule_decision``
at ``GET /admin/trace/<id>``) and aggregates outcomes as
``xllm_schedule_decisions_total{policy,reason}``. Audits are
observe-only: passing ``audit`` never changes which pair is picked.
"""

from __future__ import annotations

import abc
import math
from typing import Any, Dict, List, Optional, Tuple

from xllm_service_tpu_torch.config import LoadBalancePolicyType, ServiceOptions
from xllm_service_tpu_torch.service.instance_mgr import InstanceMgr
from xllm_service_tpu_torch.service.kvcache_mgr import GlobalKVCacheMgr


class LoadBalancePolicy(abc.ABC):
    """``select_instances_pair`` (reference loadbalance_policy.h:25-35)."""

    policy_name = "base"

    def __init__(self, mgr: InstanceMgr) -> None:
        self.mgr = mgr

    @abc.abstractmethod
    def select_instances_pair(self, token_ids: List[int],
                              audit: Optional[Dict[str, Any]] = None
                              ) -> Tuple[Optional[str], Optional[str]]: ...


class RoundRobinPolicy(LoadBalancePolicy):
    """Delegates to the instance manager's RR indexes
    (round_robin.cpp:18-22)."""

    policy_name = "round_robin"

    def select_instances_pair(self, token_ids, audit=None):
        prefill, decode = self.mgr.get_next_instance_pair()
        if audit is not None:
            audit.update(policy=self.policy_name,
                         reason="rr" if prefill else "no_instance",
                         prefill={"winner": prefill},
                         decode={"winner": decode})
        return prefill, decode


class CacheAwareRoutingPolicy(LoadBalancePolicy):
    """Score = prefix-match ratio − kv-cache usage − waiting-queue ratio,
    argmax per pool; least-loaded fallback when nothing overlaps
    (cache_aware_routing.cpp:22-87)."""

    policy_name = "cache_aware"

    def __init__(self, mgr: InstanceMgr, kvcache: GlobalKVCacheMgr,
                 block_size: int = 128) -> None:
        super().__init__(mgr)
        self.kvcache = kvcache
        self.block_size = block_size

    def _cost(self, name: str, match_score: float,
              total_blocks: int) -> Optional[Dict[str, float]]:
        """One candidate's score AND its terms — the terms are the
        explanation, so they are computed once here, not re-derived by
        the audit path (which could drift)."""
        inst = self.mgr.get(name)
        if inst is None:
            return None
        match_ratio = match_score / max(total_blocks, 1)
        kv_usage = inst.load.kv_cache_usage
        waiting_ratio = min(inst.load.waiting_requests / 16.0, 1.0)
        return {"score": match_ratio - kv_usage - waiting_ratio,
                "match_ratio": match_ratio, "kv_usage": kv_usage,
                "waiting_ratio": waiting_ratio}

    def _pick(self, pool: List[str], scores, total_blocks: int,
              audit: Optional[Dict[str, Any]] = None,
              role: str = "prefill") -> Optional[str]:
        candidates: List[Dict[str, Any]] = []
        best, best_cost = None, None
        for name in pool:
            cost = self._cost(name, scores.get(name, 0.0), total_blocks)
            if cost is None:
                continue
            candidates.append({"instance": name, **cost})
            if best_cost is None or cost["score"] > best_cost:
                best, best_cost = name, cost["score"]
        fallback_reason = None
        winner = best
        if best is None or scores.get(best, 0.0) == 0.0:
            fallback_reason = ("no_candidates" if best is None
                               else "no_prefix_overlap")
            fallback = self.mgr.least_loaded_instance(pool)
            winner = fallback or best
        if audit is not None:
            audit[role] = {"candidates": candidates, "winner": winner,
                           "fallback_reason": fallback_reason}
        return winner

    def select_instances_pair(self, token_ids, audit=None):
        total_blocks = max(len(token_ids) // self.block_size, 1)
        matched, scores, holders = self.kvcache.match_prefix_tiers(
            token_ids)
        if audit is not None:
            # Hand the walk's full evidence to the scheduler's
            # fetch-vs-recompute planner (it pops this before the audit
            # reaches the span): ONE prefix match per schedule(), not
            # one for scoring and another for planning.
            audit["_match_tiers"] = (matched, holders)
        prefill = self._pick(self.mgr.prefill_instances(), scores,
                             total_blocks, audit=audit, role="prefill")
        decode = self._pick(self.mgr.decode_instances(), scores,
                            total_blocks, audit=audit, role="decode")
        if audit is not None:
            fallbacks = [r for r in ("prefill", "decode")
                         if audit.get(r, {}).get("fallback_reason")]
            audit.update(
                policy=self.policy_name, total_blocks=total_blocks,
                reason=("fallback" if fallbacks else "scored")
                if (prefill or decode) else "no_instance")
        return prefill if prefill is not None else decode, decode


class SloAwarePolicy(LoadBalancePolicy):
    """Routes via the TimePredictor-driven SLO selection; RR fallback for
    un-tokenized requests (slo_aware_policy.cpp:26-38)."""

    policy_name = "slo_aware"

    def select_instances_pair(self, token_ids, audit=None):
        if not token_ids:
            prefill, decode = self.mgr.get_next_instance_pair()
            if audit is not None:
                audit.update(policy=self.policy_name,
                             reason="rr_untokenized",
                             prefill={"winner": prefill},
                             decode={"winner": decode})
            return prefill, decode
        backlog_terms: dict = {}
        prefill, decode, est_ttft = self.mgr.select_instance_pair_on_slo(
            len(token_ids), audit=backlog_terms)
        reason = "slo"
        if prefill is None:
            prefill, rr_decode = self.mgr.get_next_instance_pair()
            decode = decode or rr_decode
            reason = "fallback" if prefill else "no_instance"
        if audit is not None:
            # The winner's heartbeat-advertised prefill backlog rides
            # the audit (attrs.schedule_decision) so a routing decision
            # shaped by worker-side queueing is explainable after the
            # fact, not just the ledger-estimated TTFT.
            prefill_terms = {"winner": prefill,
                             "estimated_ttft_ms":
                                 round(est_ttft, 3)
                                 if math.isfinite(est_ttft)
                                 else None}
            prefill_terms.update(backlog_terms)
            audit.update(policy=self.policy_name, reason=reason,
                         prefill=prefill_terms,
                         decode={"winner": decode})
        return prefill, decode


def create_policy(opts: ServiceOptions, mgr: InstanceMgr,
                  kvcache: GlobalKVCacheMgr) -> LoadBalancePolicy:
    """Factory (reference scheduler.cpp:47-54)."""
    if opts.load_balance_policy == LoadBalancePolicyType.CACHE_AWARE:
        return CacheAwareRoutingPolicy(mgr, kvcache, opts.block_size)
    if opts.load_balance_policy == LoadBalancePolicyType.SLO_AWARE:
        return SloAwarePolicy(mgr)
    return RoundRobinPolicy(mgr)
