"""Architecture Description Graph — the FU-level IR between LEGO's front end
and back end (paper Fig. 7(a)).

``generate_adg`` is the front-end entry point: for every (workload, dataflow) spec
it solves the reuse equations (§IV-A), prunes to a minimum arborescence
(§IV-B), fuses the dataflows' interconnections (§IV-C, or a naive merge for
the Table V baseline), and sizes the banked memories (§IV-D).  The result is
a complete FU-level architecture: FUs, physical links (direct wires / skew
registers / programmable-depth FIFOs), per-dataflow data nodes, stationary
self-loops (accumulators, pinned operands), banking plans, and the single
shared address generators.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .dataflow import Dataflow
from .fusion import (DataflowSolution, FusedTensorPlan, fuse_tensor,
                     naive_merge, solve_dataflow)
from .interconnect import Reuse, solve_delay, solve_direct
from .memory import (AddressGenerator, BankingPlan, FusedBanking,
                     address_generator, analyze_banking, fuse_banking)
from .workload import Workload

__all__ = ["DataflowSpec", "ADG", "generate_adg"]


@dataclass(frozen=True)
class DataflowSpec:
    workload: Workload
    dataflow: Dataflow


@dataclass
class ADG:
    name: str
    specs: list[DataflowSpec]
    n_fus: int
    tensor_plans: dict[str, FusedTensorPlan]
    banking: dict[str, FusedBanking]
    stationary: dict[tuple[str, str], list[Reuse]]  # (df, tensor) -> self-loops
    solutions: dict[tuple[str, str], DataflowSolution]
    addr_gens: dict[tuple[str, str], list[AddressGenerator]]

    # -- stats used by the back end / cost model -------------------------
    @property
    def dataflow_names(self) -> list[str]:
        return [s.dataflow.name for s in self.specs]

    def spec(self, df_name: str) -> DataflowSpec:
        for s in self.specs:
            if s.dataflow.name == df_name:
                return s
        raise KeyError(df_name)

    @property
    def n_links(self) -> int:
        return sum(p.n_links for p in self.tensor_plans.values())

    @property
    def n_delay_links(self) -> int:
        return sum(1 for p in self.tensor_plans.values()
                   for l in p.links.values() if "delay" in l.kind)

    @property
    def n_data_nodes(self) -> int:
        return sum(len(p.all_data_nodes) for p in self.tensor_plans.values())

    def n_muxes(self) -> int:
        n = 0
        for p in self.tensor_plans.values():
            n += sum(1 for fan in p.mux_inputs().values() if fan > 1)
        return n

    def max_fifo_depth(self, tensor: str) -> int:
        mx = 0
        for l in self.tensor_plans[tensor].links.values():
            if "delay" in l.kind:
                mx = max(mx, max(l.users.values()))
        return mx

    def summary(self) -> dict:
        return {
            "name": self.name,
            "n_fus": self.n_fus,
            "dataflows": self.dataflow_names,
            "links": self.n_links,
            "delay_links": self.n_delay_links,
            "data_nodes": self.n_data_nodes,
            "muxes": self.n_muxes(),
            "banks": {t: b.total_banks for t, b in self.banking.items()},
        }

    # -- simulation support (shared by funcsim and rtlsim) ----------------
    def reuse_table(self, df_name: str, tensor: str
                    ) -> dict[tuple, tuple[np.ndarray, int]]:
        """Minimum-depth spatial reuse generator per spatial offset Δs:
        ``{Δs: (Δt, depth)}``.  This is the semantic meaning of a physical
        link under ``df_name`` — the same table both simulators use to decide
        which local timestep a forwarded operand belongs to."""
        sol = self.solutions[(df_name, tensor)]
        table: dict[tuple, tuple[np.ndarray, int]] = {}
        for r in sol.reuses:
            if r.is_spatial:
                key = tuple(r.ds)
                if key not in table or r.depth < table[key][1]:
                    table[key] = (np.array(r.dt), r.depth)
        return table

    def feeders(self, df_name: str) -> dict[str, list]:
        """Operand feed per (input tensor, FU) under ``df_name``:
        ``("mem", None)`` for data nodes, ``("link", (src_fu, Δt))`` for
        link-fed FUs (first matching physical link, minimum-depth reuse
        semantics), ``("switch", None)`` for isolated FUs served through the
        data-distribution switch every cycle (§III-C control plane)."""
        spec = self.spec(df_name)
        wl, df = spec.workload, spec.dataflow
        coords = df.fu_coords()
        n = df.n_fus
        out: dict[str, list] = {}
        for t in wl.inputs:
            table = self.reuse_table(df_name, t.name)
            plan = self.tensor_plans[t.name]
            dns = set(plan.data_nodes.get(df_name, []))
            fl: list = [None] * n
            for f in dns:
                fl[f] = ("mem", None)
            for (u, v), link in plan.links.items():
                if not any(k.split("#")[0] == df_name for k in link.users):
                    continue
                if fl[v] is not None:
                    continue
                ds = tuple((coords[v] - coords[u]).tolist())
                ent = table.get(ds)
                if ent is None:
                    continue
                fl[v] = ("link", (u, ent[0]))
            for f in range(n):
                if fl[f] is None:
                    fl[f] = ("switch", None)
            out[t.name] = fl
        return out

    def check_output_path(self, df_name: str) -> None:
        """Structural psum-routing check: every FU must reach an output data
        node of ``df_name`` through generated output links."""
        spec = self.spec(df_name)
        out_name = spec.workload.output.name
        n = spec.dataflow.n_fus
        oplan = self.tensor_plans[out_name]
        sinks = set(oplan.data_nodes.get(df_name, []))
        feeds: dict[int, list[int]] = {}
        for (u, v), link in oplan.links.items():
            if any(k.split("#")[0] == df_name for k in link.users):
                feeds.setdefault(u, []).append(v)
        reached = set(sinks)
        changed = True
        while changed:
            changed = False
            for u, vs in feeds.items():
                if u not in reached and any(v in reached for v in vs):
                    reached.add(u)
                    changed = True
        missing = set(range(n)) - reached
        assert not missing, (
            f"{out_name}: FUs {sorted(missing)[:8]} cannot commit under "
            f"{df_name}")


def generate_adg(
    specs: list[tuple[Workload, Dataflow]],
    *,
    name: str = "lego",
    d_S: int = 1,
    d_T: int = 1,
    mem_edge_cost: float = 1.2,
    fuse: str = "heuristic",  # "heuristic" | "naive"
    max_delay_depth: int | None = None,
) -> ADG:
    specs = [DataflowSpec(w, d) for w, d in specs]
    n_fus = specs[0].dataflow.n_fus
    for s in specs:
        assert s.dataflow.n_fus == n_fus, "fused dataflows must share the FU array"

    # 1) per-(dataflow, tensor) reuse solving + spanning.
    # Output tensors are solved in the transposed graph (anti-arborescence):
    # partial sums flow toward commit data nodes.
    per_tensor: dict[str, list[DataflowSolution]] = {}
    roles: dict[str, str] = {}
    stationary: dict[tuple[str, str], list[Reuse]] = {}
    solutions: dict[tuple[str, str], DataflowSolution] = {}
    for s in specs:
        wl, df = s.workload, s.dataflow
        for t in wl.tensors:
            assert roles.setdefault(t.name, t.role) == t.role, \
                f"tensor {t.name} used with mixed roles across dataflows"
            reuses = (solve_direct(wl, df, t.name, d_S)
                      + solve_delay(wl, df, t.name, d_S, d_T, max_delay_depth))
            sol = solve_dataflow(wl, df, t.name, reuses, mem_edge_cost,
                                 reverse=(t.role == "output"))
            per_tensor.setdefault(t.name, []).append(sol)
            solutions[(df.name, t.name)] = sol
            stationary[(df.name, t.name)] = [r for r in reuses
                                             if not r.is_spatial]

    # 2) fusion across dataflows (§IV-C); output-tensor plans are solved in
    # the transposed world, then flipped back into flow direction.
    fuser = fuse_tensor if fuse == "heuristic" else naive_merge
    tensor_plans = {t: fuser(sols) for t, sols in per_tensor.items()}
    for t, plan in tensor_plans.items():
        if roles[t] == "output":
            plan.links = {(v, u): _flip_link(l)
                          for (u, v), l in plan.links.items()}

    # 3) banking (§IV-D) + address generators
    banking: dict[str, FusedBanking] = {}
    addr_gens: dict[tuple[str, str], list[AddressGenerator]] = {}
    for t, sols in per_tensor.items():
        plans: list[BankingPlan] = []
        for sol in sols:
            dn = tensor_plans[t].data_nodes.get(sol.df.name, [])
            if not dn:
                dn = sol.data_nodes  # fall back to per-dataflow result
            plans.append(analyze_banking(_wl_of(specs, sol.df.name), sol.df,
                                         t, dn))
            coords = sol.df.fu_coords()
            addr_gens[(sol.df.name, t)] = [
                address_generator(_wl_of(specs, sol.df.name), sol.df, t,
                                  coords[f]) for f in dn]
        banking[t] = fuse_banking(plans)

    return ADG(name=name, specs=specs, n_fus=n_fus, tensor_plans=tensor_plans,
               banking=banking, stationary=stationary, solutions=solutions,
               addr_gens=addr_gens)


def _flip_link(link):
    link.src, link.dst = link.dst, link.src
    return link


def _wl_of(specs: list[DataflowSpec], df_name: str) -> Workload:
    for s in specs:
        if s.dataflow.name == df_name:
            return s.workload
    raise KeyError(df_name)
