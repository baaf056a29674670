"""Composable resilience policies: the middleware layer of the public API.

Historically the engine exposed three *disjoint* resilience mechanisms,
each with its own kwarg and its own code path through the
:class:`~repro.engine.dfk.DataFlowKernel`:

* ``retry_handler=`` — one global callable deciding every retry;
* ``proactive=`` — the :class:`~repro.core.proactive.ProactiveSentinel`
  with its inline dispatch check + retry review + periodic sweep;
* ``speculative_execution=`` — the straggler watcher.

This module unifies all three behind one abstraction: a
:class:`ResiliencePolicy` is ordered middleware with lifecycle hooks
(``on_submit``, ``on_dispatch``, ``on_running``, ``on_failure``,
``on_result``, ``on_tick`` and the ``review_decision`` second-opinion
pass), and a :class:`PolicyStack` composes policies so the *first
decisive* :class:`~repro.engine.retry_api.RetryDecision` wins.  Stacks
are resolved per task invocation: per-call policies (``TaskDef.options
(policy=...)``) run first, then the enclosing
:class:`~repro.engine.workflow.Workflow` chain (innermost scope first),
then the engine-level stack, with Parsl's baseline retry-in-place as the
terminal fallback.

HPX-style task-level combinators (Gupta et al., *Implementing Software
Resiliency in HPX*) are built on the same machinery: :func:`replay`
re-executes a failed task up to *n* times, :func:`replicate` races *n*
concurrent copies of the task (via the engine's speculative-copy
mechanism) and accepts the first result that passes ``validate``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable

from repro_torch.core.failures import DependencyError, FailureReport
from repro_torch.engine.retry_api import (
    Action,
    RetryDecision,
    SchedulingContext,
    baseline_retry_handler,
)


class ResiliencePolicy:
    """One layer of resilience middleware.

    Subclasses override any subset of the hooks; every hook has a no-op
    default so a policy states only what it cares about.  Hooks must be
    fast and must not block — ``on_dispatch``/``on_failure`` run on the
    engine's event thread, ``on_running``/``on_result`` on worker
    threads.

    Hook contract:

    ``on_submit(rec, ctx)``
        Task invocation entered the engine.  May annotate the record
        (e.g. :class:`ReplicatePolicy` requests racing copies here).
    ``on_dispatch(rec, ctx) -> str | None``
        About to place the task.  A non-``None`` reason string vetoes
        the dispatch: the task is fast-failed with that reason.
    ``on_running(rec, ctx)``
        A worker picked the task up.
    ``on_failure(rec, report, ctx) -> RetryDecision | None``
        The task failed.  Return a decision to *decide* (stops the
        chain), or ``None`` to pass to the next policy.
    ``review_decision(rec, report, decision, ctx) -> RetryDecision``
        Second-opinion pass over the decisive decision (every policy
        sees it, in stack order).  Used e.g. by :class:`ProactivePolicy`
        to veto retries destined to fail.
    ``on_result(rec, result, ctx) -> BaseException | None``
        The task produced a result.  Return an exception to *invalidate*
        it — the result is discarded and the exception routed through
        the failure path (this is how ``replicate(validate=)`` rejects
        bad replicas).
    ``on_tick(ctx)``
        Periodic heartbeat on the engine's event loop.
    ``admit_request(req, ctx) -> str | None``
        Serving-plane admission check, called by the
        :class:`~repro.serve.queue.RequestQueue` before a request is
        enqueued.  A non-``None`` reason string *rejects* the request up
        front (it never reaches a decode slot) — the request-plane analog
        of ``on_dispatch``'s predictive fast-fail.  Overridden by
        :class:`~repro.serve.queue.SLOAdmissionPolicy`.
    ``memo_lookup(rec, ctx) -> (hit, value)``
        Checkpoint hook, called at dispatch once dependencies resolved:
        a ``(True, value)`` return short-circuits execution — the engine
        resolves the future with ``value`` and never places the task.
        Overridden by :class:`~repro.checkpoint.task_store.
        CheckpointPolicy`.
    ``memo_commit(rec, result, ctx)``
        Persist a successful result.  Fired only for the attempt that
        won the task (post duplicate-completion guard), never for a
        discarded racing copy.
    ``memo_invalidate(rec, reason) -> removed keys``
        Dependency-aware rollback, fired when a memoized result fails
        the stack's ``on_result`` validation: drop the cached entry and
        its descendants so the lineage re-executes.
    """

    def bind(self, dfk: Any) -> None:
        """Attach to a running engine (idempotent)."""

    def unbind(self) -> None:
        """Detach from the engine at shutdown."""

    def on_submit(self, rec: Any, ctx: SchedulingContext) -> None: ...

    def on_dispatch(self, rec: Any, ctx: SchedulingContext) -> str | None:
        return None

    def on_running(self, rec: Any, ctx: SchedulingContext) -> None: ...

    def on_failure(self, rec: Any, report: FailureReport,
                   ctx: SchedulingContext) -> RetryDecision | None:
        return None

    def review_decision(self, rec: Any, report: FailureReport,
                        decision: RetryDecision,
                        ctx: SchedulingContext) -> RetryDecision:
        return decision

    def on_result(self, rec: Any, result: Any,
                  ctx: SchedulingContext) -> BaseException | None:
        return None

    def on_tick(self, ctx: SchedulingContext) -> None: ...

    def admit_request(self, req: Any, ctx: SchedulingContext) -> str | None:
        return None

    def memo_lookup(self, rec: Any, ctx: SchedulingContext) -> tuple[bool, Any]:
        return (False, None)

    def memo_commit(self, rec: Any, result: Any,
                    ctx: SchedulingContext) -> None: ...

    def memo_invalidate(self, rec: Any, reason: str = "") -> list[str]:
        return []

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__}>"


def normalize_policies(policy: Any) -> tuple[ResiliencePolicy, ...]:
    """Coerce the public ``policy=`` argument into a policy tuple.

    Accepts ``None``, a single :class:`ResiliencePolicy`, a
    :class:`PolicyStack`, a bare retry-handler callable (wrapped in
    :class:`RetryHandlerPolicy`), or an iterable mixing any of these.
    """
    if policy is None:
        return ()
    if isinstance(policy, PolicyStack):
        return policy.policies
    if isinstance(policy, ResiliencePolicy):
        return (policy,)
    if isinstance(policy, type) and issubclass(policy, ResiliencePolicy):
        # the class itself (missing parens) is callable, so without this
        # check it would be silently wrapped as a broken retry handler
        raise TypeError(
            f"{policy.__name__} is a policy class, not an instance — "
            f"did you mean {policy.__name__}()?")
    if callable(policy):
        return (RetryHandlerPolicy(policy),)
    if isinstance(policy, (str, bytes)):
        # a str is an Iterable of 1-char strs: recursing would blow the
        # stack instead of reaching the descriptive error below
        raise TypeError(f"cannot interpret {policy!r} as a resilience policy")
    if isinstance(policy, Iterable):
        out: list[ResiliencePolicy] = []
        for p in policy:
            out.extend(normalize_policies(p))
        return tuple(out)
    raise TypeError(f"cannot interpret {policy!r} as a resilience policy")


class PolicyStack(ResiliencePolicy):
    """An ordered composition of policies; itself a policy.

    ``on_dispatch`` returns the first veto; ``on_failure`` returns the
    first decisive decision (falling back to
    :func:`~repro.engine.retry_api.baseline_retry_handler` when no
    policy decides), then runs every policy's ``review_decision`` over
    it in stack order.  A policy whose ``on_failure`` raises produces a
    terminal FAIL (a buggy decider must not hang the task); a raising
    ``review_decision`` is ignored (the decision stands) — both match
    the engine's historical contract for ``retry_handler`` /
    ``ProactiveSentinel`` bugs.  Swallowed hook exceptions are surfaced
    through ``on_error`` (the engine wires its system-event reporter in)
    so a misbehaving policy degrades resilience *visibly*.
    """

    def __init__(self, policies: Any = (),
                 on_error: Callable[[str, BaseException], Any] | None = None):
        self.policies = normalize_policies(policies)
        self.on_error = on_error
        base = ResiliencePolicy
        # precomputed per-hook subsets: the hot paths (dispatch, running,
        # result) skip policies that kept the no-op default
        self._dispatchers = tuple(
            p for p in self.policies if type(p).on_dispatch is not base.on_dispatch)
        self._submitters = tuple(
            p for p in self.policies if type(p).on_submit is not base.on_submit)
        self._runners = tuple(
            p for p in self.policies if type(p).on_running is not base.on_running)
        self._deciders = tuple(
            p for p in self.policies if type(p).on_failure is not base.on_failure)
        self._reviewers = tuple(
            p for p in self.policies
            if type(p).review_decision is not base.review_decision)
        self._validators = tuple(
            p for p in self.policies if type(p).on_result is not base.on_result)
        self._tickers = tuple(
            p for p in self.policies if type(p).on_tick is not base.on_tick)
        self._admitters = tuple(
            p for p in self.policies
            if type(p).admit_request is not base.admit_request)
        self._checkpointers = tuple(
            p for p in self.policies
            if type(p).memo_lookup is not base.memo_lookup
            or type(p).memo_commit is not base.memo_commit
            or type(p).memo_invalidate is not base.memo_invalidate)

    # -- composition -----------------------------------------------------
    def __iter__(self):
        return iter(self.policies)

    def __len__(self) -> int:
        return len(self.policies)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        inner = ", ".join(type(p).__name__ for p in self.policies)
        return f"<PolicyStack [{inner}]>"

    @property
    def wants_running(self) -> bool:
        return bool(self._runners)

    # -- lifecycle -------------------------------------------------------
    def bind(self, dfk: Any) -> None:
        for p in self.policies:
            p.bind(dfk)

    def unbind(self) -> None:
        for p in self.policies:
            p.unbind()

    def _report(self, policy: ResiliencePolicy, hook: str,
                err: BaseException) -> None:
        """Surface a swallowed hook exception (engine system event)."""
        if self.on_error is not None:
            try:
                self.on_error(f"policy-{hook}:{type(policy).__name__}", err)
            except Exception:  # noqa: BLE001 - reporter bugs stay contained
                pass

    # -- hooks -----------------------------------------------------------
    def on_submit(self, rec: Any, ctx: SchedulingContext) -> None:
        for p in self._submitters:
            try:
                p.on_submit(rec, ctx)
            except Exception as err:  # noqa: BLE001 - must not block submission
                self._report(p, "on_submit", err)

    def on_dispatch(self, rec: Any, ctx: SchedulingContext) -> str | None:
        for p in self._dispatchers:
            try:
                reason = p.on_dispatch(rec, ctx)
            except Exception as err:  # noqa: BLE001 - must not block dispatch
                self._report(p, "on_dispatch", err)
                continue
            if reason is not None:
                return reason
        return None

    def on_running(self, rec: Any, ctx: SchedulingContext) -> None:
        for p in self._runners:
            try:
                p.on_running(rec, ctx)
            except Exception as err:  # noqa: BLE001
                self._report(p, "on_running", err)

    def on_failure(self, rec: Any, report: FailureReport,
                   ctx: SchedulingContext) -> RetryDecision | None:
        for p in self._deciders:
            try:
                decision = p.on_failure(rec, report, ctx)
            except Exception as err:  # noqa: BLE001 - decider bug = fail the task
                return RetryDecision(
                    Action.FAIL,
                    reason=f"policy {type(p).__name__} error: {err!r}")
            if decision is not None:
                return decision
        return None

    def review_decision(self, rec: Any, report: FailureReport,
                        decision: RetryDecision,
                        ctx: SchedulingContext) -> RetryDecision:
        for p in self._reviewers:
            try:
                decision = p.review_decision(rec, report, decision, ctx)
            except Exception as err:  # noqa: BLE001 - reviewer bug = keep the decision
                self._report(p, "review_decision", err)
                continue
        return decision

    def on_result(self, rec: Any, result: Any,
                  ctx: SchedulingContext) -> BaseException | None:
        for p in self._validators:
            try:
                exc = p.on_result(rec, result, ctx)
            except Exception as err:  # noqa: BLE001 - validator raising = invalid
                return err
            if exc is not None:
                return exc
        return None

    def on_tick(self, ctx: SchedulingContext) -> None:
        for p in self._tickers:
            try:
                p.on_tick(ctx)
            except Exception as err:  # noqa: BLE001
                self._report(p, "on_tick", err)

    def admit_request(self, req: Any, ctx: SchedulingContext) -> str | None:
        """First rejection wins; a raising admitter degrades to "admit"
        (a buggy admission policy must shed resilience, not traffic)."""
        for p in self._admitters:
            try:
                reason = p.admit_request(req, ctx)
            except Exception as err:  # noqa: BLE001 - admitter bug => admit
                self._report(p, "admit_request", err)
                continue
            if reason is not None:
                return reason
        return None

    def memo_lookup(self, rec: Any, ctx: SchedulingContext) -> tuple[bool, Any]:
        """First checkpoint hit wins; a raising store degrades to a miss
        (memoization must never be able to wedge dispatch)."""
        for p in self._checkpointers:
            try:
                hit, value = p.memo_lookup(rec, ctx)
            except Exception as err:  # noqa: BLE001 - store bug => execute
                self._report(p, "memo_lookup", err)
                continue
            if hit:
                return True, value
        return False, None

    def memo_commit(self, rec: Any, result: Any,
                    ctx: SchedulingContext) -> None:
        """Commit fans out to every checkpoint store in the stack."""
        for p in self._checkpointers:
            try:
                p.memo_commit(rec, result, ctx)
            except Exception as err:  # noqa: BLE001 - a failed commit only
                self._report(p, "memo_commit", err)  # costs a future memo hit

    def memo_invalidate(self, rec: Any, reason: str = "") -> list[str]:
        """Rollback fans out to *every* checkpoint store in the stack: an
        invalid cached result must not survive anywhere."""
        removed: list[str] = []
        for p in self._checkpointers:
            try:
                removed.extend(p.memo_invalidate(rec, reason=reason))
            except Exception as err:  # noqa: BLE001
                self._report(p, "memo_invalidate", err)
        return removed

    # -- the full failure-routing protocol -------------------------------
    def decide(self, rec: Any, report: FailureReport,
               ctx: SchedulingContext) -> RetryDecision:
        """First decisive ``on_failure`` (baseline fallback), then review."""
        decision = self.on_failure(rec, report, ctx)
        if decision is None:
            decision = baseline_retry_handler(rec, report, ctx)
        return self.review_decision(rec, report, decision, ctx)


# --------------------------------------------------------------------- #
# adapters: today's three mechanisms as stack members
# --------------------------------------------------------------------- #
class RetryHandlerPolicy(ResiliencePolicy):
    """Adapter: a legacy ``retry_handler`` callable as a stack member.

    The handler's decision is always decisive (legacy handlers never
    abstain) — install it last if other policies should get a say first.
    """

    def __init__(self, handler: Callable[..., RetryDecision]):
        self.handler = handler

    def on_failure(self, rec: Any, report: FailureReport,
                   ctx: SchedulingContext) -> RetryDecision | None:
        return self.handler(rec, report, ctx)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        h = getattr(self.handler, "__name__", type(self.handler).__name__)
        return f"<RetryHandlerPolicy {h}>"


class WrathPolicy(RetryHandlerPolicy):
    """WRATH's resilience module (§V) as a policy: taxonomy-driven
    categorization + denylist + hierarchical four-rung retry."""

    def __init__(self, **kwargs: Any):
        from repro_torch.core.policy import ResiliencePolicyEngine
        super().__init__(ResiliencePolicyEngine(**kwargs))

    @property
    def engine(self):
        return self.handler

    @property
    def decisions(self) -> list[dict]:
        return self.handler.decisions


class ProactivePolicy(ResiliencePolicy):
    """The proactive sentinel (§IV↔§V feedback loop) as a policy.

    ``on_dispatch`` is the sentinel's predictive fast-fail check;
    ``review_decision`` is its retry review (vetoing retries destined to
    fail).  The sentinel's periodic drain/feasibility sweep is scheduled
    by the sentinel itself when the stack binds to the engine.
    """

    def __init__(self, proactive: Any = True):
        # lazy import: repro.core.proactive imports repro.engine.retry_api,
        # which initializes this package — a module-level import would cycle
        from repro_torch.core.proactive import ProactiveSentinel, make_sentinel
        self.sentinel: ProactiveSentinel = (
            make_sentinel(proactive) or make_sentinel(True))

    def bind(self, dfk: Any) -> None:
        if self.sentinel.dfk is None:
            self.sentinel.attach(dfk)

    def unbind(self) -> None:
        self.sentinel.detach()

    def on_dispatch(self, rec: Any, ctx: SchedulingContext) -> str | None:
        return self.sentinel.check_dispatch(rec)

    def review_decision(self, rec: Any, report: FailureReport,
                        decision: RetryDecision,
                        ctx: SchedulingContext) -> RetryDecision:
        if decision.action is Action.FAIL:
            return decision
        return self.sentinel.review_retry(rec, report, decision)


class StragglerPolicy(ResiliencePolicy):
    """Speculative re-execution of stragglers as a policy.

    Each tick, tasks running beyond ``factor`` × their expected duration
    (profile-derived p95, ``est_duration_s`` fallback) get a backup copy
    on another node; first finisher wins.  ``scope`` restricts the watch
    to one workflow's subtree (``None`` = every task on the engine).
    """

    def __init__(self, factor: float = 3.0, *, scope: Any = None):
        self.factor = factor
        self.scope = scope
        self.dfk: Any = None

    def bind(self, dfk: Any) -> None:
        self.dfk = dfk

    def unbind(self) -> None:
        self.dfk = None

    def on_tick(self, ctx: SchedulingContext) -> None:
        if self.dfk is not None:
            self.dfk.check_stragglers(factor=self.factor, scope=self.scope)


# --------------------------------------------------------------------- #
# HPX-style combinators (async_replay / async_replicate analogs)
# --------------------------------------------------------------------- #
class ReplayPolicy(ResiliencePolicy):
    """``replay(n)``: re-execute a failed task until *n* total attempts.

    The HPX ``async_replay`` analog: any failure (other than a terminal
    dependency failure) is retried — on a scheduler-chosen node — until
    the task has executed ``n`` times.  What happens then is
    ``on_exhausted``: ``"fail"`` (default, HPX semantics) terminates the
    task decisively — exactly *n* attempts, overriding every policy
    below; ``"defer"`` abstains so deeper stack members (e.g.
    :class:`WrathPolicy`) take over once the replay budget is spent.
    """

    def __init__(self, n: int, on_exhausted: str = "fail"):
        if n < 1:
            raise ValueError(f"replay count must be >= 1, got {n}")
        if on_exhausted not in ("fail", "defer"):
            raise ValueError(
                f"on_exhausted must be 'fail' or 'defer', got {on_exhausted!r}")
        self.n = n
        self.on_exhausted = on_exhausted

    def on_submit(self, rec: Any, ctx: SchedulingContext) -> None:
        if self.on_exhausted == "defer":
            # replay attempts must not eat the deeper policies' retry
            # budget: a handler below would otherwise see retry_count >=
            # max_retries the moment replay defers and fail immediately
            # instead of performing its advertised recovery
            rec.max_retries += self.n - 1

    def on_failure(self, rec: Any, report: FailureReport,
                   ctx: SchedulingContext) -> RetryDecision | None:
        if isinstance(report.exception, DependencyError):
            return RetryDecision(Action.FAIL,
                                 reason="dependency failed (dep_fail)")
        attempt = rec.retry_count + 1          # attempts executed so far
        if attempt < self.n:
            return RetryDecision(
                Action.RETRY,
                reason=f"replay attempt {attempt + 1}/{self.n}")
        if self.on_exhausted == "defer":
            return None                        # hand over to deeper policies
        return RetryDecision(
            Action.FAIL, reason=f"replay budget exhausted ({self.n} attempts)")

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<ReplayPolicy n={self.n} then={self.on_exhausted}>"


class ReplicationError(RuntimeError):
    """A replicated task's result failed its ``validate`` predicate."""


class ReplicatePolicy(ResiliencePolicy):
    """``replicate(n, validate=)``: race *n* concurrent copies of a task.

    The HPX ``async_replicate`` analog, built on the engine's
    speculative-copy machinery (shared future, winner-takes-all,
    losers cancelled).  ``on_submit`` requests ``n - 1`` racing copies
    (launched right after the original is placed); ``on_result``
    applies ``validate`` so an invalid result — from *any* replica — is
    discarded instead of winning the race.
    """

    def __init__(self, n: int, validate: Callable[[Any], bool] | None = None):
        if n < 1:
            raise ValueError(f"replica count must be >= 1, got {n}")
        self.n = n
        self.validate = validate

    def on_submit(self, rec: Any, ctx: SchedulingContext) -> None:
        rec.replicas = max(rec.replicas, self.n - 1)

    def on_result(self, rec: Any, result: Any,
                  ctx: SchedulingContext) -> BaseException | None:
        if self.validate is None:
            return None
        try:
            ok = bool(self.validate(result))
        except Exception as err:  # noqa: BLE001 - validator raising = invalid
            return ReplicationError(
                f"replica validator raised {type(err).__name__}: {err}")
        if not ok:
            return ReplicationError(
                f"replica result {result!r} rejected by validator")
        return None

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<ReplicatePolicy n={self.n}>"


def replay(n: int, on_exhausted: str = "fail") -> ReplayPolicy:
    """HPX-style ``async_replay``: retry a failed task up to ``n`` total
    attempts (``replay(1)`` = fail fast on first failure).
    ``on_exhausted="defer"`` hands over to deeper policies instead of
    failing when the budget runs out."""
    return ReplayPolicy(n, on_exhausted)


def replicate(n: int, validate: Callable[[Any], bool] | None = None) -> ReplicatePolicy:
    """HPX-style ``async_replicate``: run ``n`` racing copies, accept the
    first result that passes ``validate`` (``None`` = first finisher)."""
    return ReplicatePolicy(n, validate)


# --------------------------------------------------------------------- #
# deprecation shims
# --------------------------------------------------------------------- #
def shim_legacy_kwargs(*, retry_handler: Any = None, proactive: Any = False,
                       speculative_execution: bool = False,
                       straggler_factor: float = 3.0,
                       warn: bool = True) -> tuple[ResiliencePolicy, ...]:
    """Adapt the pre-stack DFK kwargs into an equivalent policy tuple.

    Emits one :class:`DeprecationWarning` per legacy kwarg used (``warn=
    False`` for internal compat callers that already announced it).
    """
    import warnings

    parts: list[ResiliencePolicy] = []
    if retry_handler is not None:
        if warn:
            warnings.warn(
                "DataFlowKernel(retry_handler=...) is deprecated; pass "
                "policy=[RetryHandlerPolicy(handler)] (or the handler in a "
                "policy list) instead", DeprecationWarning, stacklevel=3)
        parts.append(RetryHandlerPolicy(retry_handler))
    if proactive:
        if warn:
            warnings.warn(
                "DataFlowKernel(proactive=...) is deprecated; pass "
                "policy=[..., ProactivePolicy()] instead",
                DeprecationWarning, stacklevel=3)
        parts.append(ProactivePolicy(proactive))
    if speculative_execution:
        if warn:
            warnings.warn(
                "DataFlowKernel(speculative_execution=True) is deprecated; "
                "pass policy=[..., StragglerPolicy(factor)] instead",
                DeprecationWarning, stacklevel=3)
        parts.append(StragglerPolicy(straggler_factor))
    return tuple(parts)
