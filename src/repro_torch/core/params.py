"""STrack / RoCEv2 transport parameters.

Table 1 of the paper, plus network-derived quantities. All times are in
MICROSECONDS and all sizes in BYTES unless a field name says otherwise.
The congestion window is kept in PACKETS (floats) — the paper's constants
are specified in MTU units scaled by ``bdp_sf`` so packet units keep the
algebra identical to Table 1.

Reference network of Table 1: 100 Gbps links, 12 us network base RTT.
``bdp_sf`` and ``delay_sf`` rescale the constants to any link speed / RTT.

The port keeps its own copy of ``repro.core.params`` (same names, same
values): importing the JAX package's module would run
``repro/core/__init__.py``, which imports jax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

GBPS = 1e9 / 8 / 1e6  # bytes per microsecond for 1 Gbps

#: Wire size of SACK / NACK / CNP / probe packets (bytes).  Shared by the
#: event oracle (``core.ref.ACK_SIZE``) and the fabric's reverse-path and
#: PFC byte accounting.
ACK_WIRE_BYTES = 64

#: Store-and-forward hops of one direction of a cross-ToR path on the
#: 2-tier Clos: host NIC -> ToR uplink -> spine downlink -> host downlink.
#: The ACK path traverses the same count in reverse.
CLOS_HOPS = 4


def bytes_per_us(gbps: float) -> float:
    """Link rate in bytes/us for a given Gbps figure."""
    return gbps * GBPS


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Physical network the transport runs over."""

    link_gbps: float = 400.0
    base_rtt_us: float = 8.0      # network-wide base RTT (paper: 8 us)
    mtu_bytes: int = 4096
    # Switch config (paper Section 4.1).
    ecn_kmin_frac: float = 0.25   # K_min = 25% BDP
    ecn_kmax_frac: float = 0.75   # K_max = 75% BDP
    drop_frac: float = 5.0        # drop when queue exceeds 5 BDP
    # Per-link propagation delay (us).  None derives it from base_rtt_us so
    # that an uncongested cross-ToR data+ACK round trip (CLOS_HOPS
    # store-and-forward hops each way, MTU data out / ACK_WIRE_BYTES back)
    # realizes exactly base_rtt_us — the shared per-hop delay model of the
    # jitted fabric AND the event oracle (apples-to-apples parity).
    hop_prop_us: Optional[float] = None

    @property
    def rate_Bpus(self) -> float:
        return bytes_per_us(self.link_gbps)

    @property
    def bdp_bytes(self) -> float:
        """Bandwidth-delay product (400 Gbps x 8 us = 400 KB in the paper)."""
        return self.rate_Bpus * self.base_rtt_us

    @property
    def bdp_pkts(self) -> float:
        return self.bdp_bytes / self.mtu_bytes

    @property
    def ecn_kmin_bytes(self) -> float:
        return self.ecn_kmin_frac * self.bdp_bytes

    @property
    def ecn_kmax_bytes(self) -> float:
        return self.ecn_kmax_frac * self.bdp_bytes

    @property
    def drop_bytes(self) -> float:
        return self.drop_frac * self.bdp_bytes

    @property
    def mtu_serialize_us(self) -> float:
        return self.mtu_bytes / self.rate_Bpus

    @property
    def ack_serialize_us(self) -> float:
        return ACK_WIRE_BYTES / self.rate_Bpus

    @property
    def hop_prop_effective_us(self) -> float:
        """Per-link propagation delay: ``hop_prop_us`` when set, else
        derived so base RTT = CLOS_HOPS * (mtu_ser + prop) forward plus
        CLOS_HOPS * (ack_ser + prop) back.  Clipped at 0 when base_rtt_us
        is below the serialization floor (the realized RTT is then the
        floor itself)."""
        if self.hop_prop_us is not None:
            return self.hop_prop_us
        ser = CLOS_HOPS * (self.mtu_serialize_us + self.ack_serialize_us)
        return max(0.0, (self.base_rtt_us - ser) / (2 * CLOS_HOPS))


# Table 1 reference point: constants are specified for 100 Gbps / 12 us.
_REF_RATE_BPUS = bytes_per_us(100.0)
_REF_RTT_US = 12.0


@dataclasses.dataclass(frozen=True)
class STrackParams:
    """Table 1 of the paper, in packet (MTU) units.

    cwnd is maintained in packets; Table 1's byte-valued constants are
    divided by MTU so e.g. ``beta = 5 * bdp_sf`` packets.
    """

    base_rtt_us: float            # network base RTT
    target_qdelay_us: float       # target queuing delay == net base RTT
    target_qhigh_us: float        # 3 * target_Qdelay
    ewma: float                   # RTT averaging weight
    bdp_sf: float                 # BDP / (100Gbps * 12us)
    delay_sf: float               # base_rtt / 12us
    beta_pkts: float              # additive increase: 5 * MTU * bdp_sf (in pkts: 5*bdp_sf)
    eta_pkts: float               # fairness shuffle: 0.15 * MTU * bdp_sf
    alpha_pkts_per_us: float      # RTT gain: 4.0 * bdp_sf * delay_sf * MTU / base_rtt
    gamma: float                  # multiplicative decrease = 0.8
    max_cwnd_pkts: float          # roughly the BDP
    min_cwnd_pkts: float          # floor (fractional windows allowed: paper's 1.3 pkt point)
    max_paths: int                # entropy space for spray (paper: 256)
    min_ooo_threshold: int        # OOO loss-detection floor (paper: 5)
    probe_rtts: float             # probe after n=3 base RTTs of ACK silence
    rto_us: float                 # retransmission timeout (hundreds of us)
    bitmap_reset_rtts: float      # spray bitmap reset cadence (1-2 RTTs)
    sack_bitmap_bits: int         # bits carried per SACK (Fig 7: 64)
    rcv_bitmap_bits: int          # receiver reorder bitmap size (e.g. 256)
    ack_coalesce_bytes: float     # SACK emitted every this many received bytes
    mtu_bytes: int


def make_strack_params(
    net: NetworkSpec,
    *,
    max_paths: int = 256,
    min_ooo_threshold: int = 5,
    probe_rtts: float = 3.0,
    rto_us: float = 400.0,
    bitmap_reset_rtts: float = 2.0,
    sack_bitmap_bits: int = 64,
    rcv_bitmap_bits: int = 256,
    ack_coalesce_pkts: float = 2.0,
    max_cwnd_bdp_frac: float = 1.0,
) -> STrackParams:
    """Instantiate Table 1 for a given network (scaling via bdp_sf/delay_sf)."""
    bdp_sf = net.bdp_bytes / (_REF_RATE_BPUS * _REF_RTT_US)
    delay_sf = net.base_rtt_us / _REF_RTT_US
    target_qdelay = net.base_rtt_us  # "target_Qdelay = net_base_rtt"
    return STrackParams(
        base_rtt_us=net.base_rtt_us,
        target_qdelay_us=target_qdelay,
        target_qhigh_us=3.0 * target_qdelay,
        ewma=0.125,
        bdp_sf=bdp_sf,
        delay_sf=delay_sf,
        beta_pkts=5.0 * bdp_sf,
        eta_pkts=0.15 * bdp_sf,
        # Table 1: alpha = 4.0 * bdp_sf * delay_sf * MTU / base_rtt (bytes/us)
        # -> packets/us after the MTU division.
        alpha_pkts_per_us=4.0 * bdp_sf * delay_sf / net.base_rtt_us,
        gamma=0.8,
        max_cwnd_pkts=max_cwnd_bdp_frac * net.bdp_pkts,
        min_cwnd_pkts=1.0 / 8.0,
        max_paths=max_paths,
        min_ooo_threshold=min_ooo_threshold,
        probe_rtts=probe_rtts,
        rto_us=rto_us,
        bitmap_reset_rtts=bitmap_reset_rtts,
        sack_bitmap_bits=sack_bitmap_bits,
        rcv_bitmap_bits=rcv_bitmap_bits,
        ack_coalesce_bytes=ack_coalesce_pkts * net.mtu_bytes,
        mtu_bytes=net.mtu_bytes,
    )


@dataclasses.dataclass(frozen=True)
class DCQCNParams:
    """DCQCN (RoCEv2's congestion control) constants, per Zhu et al. 2015.

    Rate-based: alpha ewma'd from CNP arrivals; rate cut R = R*(1-alpha/2)
    on CNP; byte-counter/timer driven recovery through fast-recovery,
    additive-increase and hyper-increase phases.
    """

    g: float = 1.0 / 256.0        # alpha ewma gain
    alpha_timer_us: float = 55.0  # alpha update interval absent CNPs
    rate_timer_us: float = 55.0   # rate increase timer (paper uses 55us)
    byte_counter: float = 10.0 * 1024 * 1024  # 10MB byte counter stage
    rai_mbps: float = 40.0 * 125  # additive increase step, bytes/us (40 Mbps=5 B/us)*... see below
    hai_mbps: float = 400.0 * 125
    f_fast_recovery: int = 5      # stages of fast recovery before AI
    min_rate_Bpus: float = 1.25   # 10 Mbps floor
    cnp_interval_us: float = 50.0  # receiver emits at most one CNP per 50us per flow

    # NOTE: rai/hai above are stored in bytes/us: 40 Mbps = 5 B/us; the
    # constructor-level *_mbps naming retains the DCQCN convention.


def make_dcqcn_params(net: NetworkSpec) -> DCQCNParams:
    # Scale increase steps with link speed ("optimized RoCEv2 setup",
    # paper Section 4.1 — a strong baseline recovers promptly at 400G+).
    rai = bytes_per_us(net.link_gbps) / 500.0    # 400G -> 100 B/us steps
    hai = 10.0 * rai
    return DCQCNParams(rai_mbps=rai, hai_mbps=hai)


@dataclasses.dataclass(frozen=True)
class RoCEParams:
    """RoCEv2 transport config: go-back-N + PFC (lossless) + DCQCN."""

    dcqcn: DCQCNParams = dataclasses.field(default_factory=DCQCNParams)
    qps_per_conn: int = 1          # entropy count (paper compares 1 and 4)
    ack_coalesce_pkts: int = 2
    rto_us: float = 400.0
    ecn_kmin_bdp: float = 1.0      # "ECN threshold to one BDP for DCQCN"
    ecn_kmax_bdp: float = 1.0
    pfc_xoff_bytes: float = 512 * 1024.0   # per-ingress pause threshold
    pfc_xon_frac: float = 0.5


def make_roce_params(net: NetworkSpec, *, qps_per_conn: int = 1) -> RoCEParams:
    """RoCEv2 baseline config scaled to ``net`` (DCQCN steps follow rate)."""
    return RoCEParams(dcqcn=make_dcqcn_params(net), qps_per_conn=qps_per_conn)
