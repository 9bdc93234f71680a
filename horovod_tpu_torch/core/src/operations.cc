// Global state, background cycle loop, response executor, C ABI.
//
// Rebuild of the reference's operations layer
// (reference: horovod/common/operations.cc:381-786 BackgroundThreadLoop /
// RunLoopOnce, :257-306 PerformOperation, :791-843 InitializeHorovodOnce,
// :867-1338 extern "C" API, :1342-1742 Enqueue*). One background thread
// per process negotiates readiness and executes CPU collectives; device
// collectives live in XLA programs and only consume the ordering this
// loop decides.

#ifdef __linux__
#ifndef _GNU_SOURCE
#define _GNU_SOURCE
#endif
#include <pthread.h>
#include <sched.h>
#endif

#include "codec.h"
#include "controller.h"
#include "device_plane.h"
#include "flightrec.h"
#include "perf.h"

#include <algorithm>
#include <chrono>
#include <cstring>
#include <memory>
#include <thread>

namespace hvd {
namespace {

using Clock = std::chrono::steady_clock;

typedef void (*DoneCb)(long long tag, int status, const char* err,
                       const void* out, long long out_bytes,
                       const long long* splits, int n_splits);

struct Global {
  TcpComm comm;
  int rank = 0;
  int size = 1;
  std::unique_ptr<Controller> controller;

  std::mutex ps_mutex;
  std::map<int, std::unique_ptr<ProcessSetState>> process_sets;  // GUARDED_BY(ps_mutex)

  std::atomic<bool> shut_down{false};
  std::atomic<bool> failed{false};
  std::thread background;

  double cycle_ms = 1.0;
  // 128 MB matches the reference's default fusion threshold
  // (reference: horovod/common/operations.cc:488).
  int64_t fusion_bytes = 128 * 1024 * 1024;
  int cache_cap = 1024;
  std::vector<char> fusion_buffer;
  // HVD_WIRE_SG=0 restores the fusion-buffer pack/unpack path for
  // fused allreduces; default is the scatter-gather ring straight over
  // tensor memory (docs/wire.md).
  bool wire_sg = true;
  // int8 error-feedback residuals keyed by tensor name
  // (docs/wire.md#compression): the quantization error of each
  // submission is carried into the tensor's next submission, so the
  // bias cancels over steps instead of accumulating. Touched only by
  // the background thread's executor; flushed when the negotiated
  // codec changes (stale residuals belong to another encoding).
  std::unordered_map<std::string, std::vector<float>> ef_residuals;
  int ef_codec = 0;
  // Removals are deferred to the end of the cycle: a "__ps_remove__"
  // barrier executes while the loop still holds pointers into the set
  // table, so the erase must not happen mid-iteration.
  std::vector<int> pending_removals;  // GUARDED_BY(ps_mutex)

  // Observability counters (reference analog: timeline + autotune
  // byte scoring, horovod/common/parameter_manager.cc).
  std::atomic<long long> ctr_responses{0};
  std::atomic<long long> ctr_cached_responses{0};
  std::atomic<long long> ctr_fused_tensors{0};
  std::atomic<long long> ctr_allreduced_tensors{0};
  std::atomic<long long> ctr_allreduce_bytes{0};
  // Connection-abort cascades this core triggered (coordination or
  // data-plane failure; not clean idle exits). Bridged as
  // hvd_aborts_total.
  std::atomic<long long> ctr_aborts{0};

  DoneCb callback = nullptr;

  // Native perf subsystem (reference: parameter_manager.cc, timeline.cc).
  // autotune_mutex guards the pointer (installed from the Python thread
  // after the loop is already running) and the manager's non-atomic
  // sample state.
  std::mutex autotune_mutex;
  std::unique_ptr<ParameterManager> autotune;  // GUARDED_BY(autotune_mutex)
  std::mutex timeline_mutex;
  std::unique_ptr<TimelineWriter> timeline;  // GUARDED_BY(timeline_mutex)
  // Tensors currently inside a NEGOTIATE_* span (mirrors the
  // reference's per-tensor TimelineState).
  std::set<std::string> tl_negotiating;  // GUARDED_BY(timeline_mutex)
  // Open top-level/activity span count per tensor in THIS timeline
  // session.
  std::map<std::string, int> tl_open_spans;  // GUARDED_BY(timeline_mutex)
  // HOROVOD_TIMELINE_MARK_CYCLES: stamp each background cycle on the
  // loop row (reference: timeline.cc MarkStartedCycle/WriteMarker).
  bool tl_mark_cycles = false;  // GUARDED_BY(timeline_mutex)
  Clock::time_point t_origin = Clock::now();

  std::mutex init_mutex;
  std::condition_variable init_cv;
  bool init_done = false;  // GUARDED_BY(init_mutex)
  Status init_status;  // GUARDED_BY(init_mutex)

  // Join callbacks per process set (tag ids).
  std::mutex join_mutex;
  std::map<int, long long> join_tags;  // GUARDED_BY(join_mutex)
};

Global* g = nullptr;

void FireCallback(long long tag, const Status& s, const void* out = nullptr,
                  int64_t out_bytes = 0, const int64_t* splits = nullptr,
                  int n_splits = 0) {
  if (g->callback) {
    g->callback(tag, (int)s.type, s.reason.c_str(), out, out_bytes,
                (const long long*)splits, n_splits);
  }
}

// Tag transport: the enqueue layer owns no Python objects; the done
// callback closure captures the integer tag handed in through the C ABI.
DoneCallback MakeDone(long long tag) {
  return [tag](const Status& s, const void* out, int64_t out_bytes,
               const int64_t* splits, int n_splits) {
    FireCallback(tag, s, out, out_bytes, splits, n_splits);
  };
}

// --------------------------------------------------- timeline phases -------
// Per-tensor phase emission (reference: timeline.cc:496-558): each
// tensor gets NEGOTIATE_<OP> (begin at slow-path entry, rank-ready
// instants on the coordinator, end at response receipt), then a
// top-level <OP> span whose children are QUEUE (waiting behind earlier
// responses in the cycle), MEMCPY_IN/OUT_FUSION_BUFFER around the
// fused pack/unpack, and the wire op (TCP_*). All helpers no-op
// cheaply when the timeline is off.

long long TlNowUs() {
  return (long long)std::chrono::duration_cast<std::chrono::microseconds>(
             Clock::now() - g->t_origin)
      .count();
}

void TlNegotiateStart(const std::string& name, OpType op) {
  // Flight recorder first: always on, independent of the timeline.
  FlightRec(FrKind::NEG_START, (long long)op, 0, 0, name.c_str());
  std::lock_guard<std::mutex> lk(g->timeline_mutex);
  if (!g->timeline) return;
  // Repeated entry (cache invalidation requeue) keeps the first span,
  // like the reference's NEGOTIATING-state guard.
  if (!g->tl_negotiating.insert(name).second) return;
  g->timeline->Begin(name, std::string("NEGOTIATE_") + OpTypeName(op),
                     TlNowUs());
}

void TlNegotiateRankReady(const std::string& name, int rank, OpType op) {
  FlightRec(FrKind::NEG_READY, rank, (long long)op, 0, name.c_str());
  std::lock_guard<std::mutex> lk(g->timeline_mutex);
  if (!g->timeline) return;
  // A peer's request can reach the coordinator before this rank pops
  // its own; first contact opens the span (reference: NegotiateStart
  // "first call takes precedence" + NegotiateRankReady).
  if (g->tl_negotiating.insert(name).second)
    g->timeline->Begin(name, std::string("NEGOTIATE_") + OpTypeName(op),
                       TlNowUs());
  g->timeline->Instant(name, std::to_string(rank), TlNowUs());
}

void TlNegotiateEnd(const std::string& name) {
  FlightRec(FrKind::NEG_END, 0, 0, 0, name.c_str());
  std::lock_guard<std::mutex> lk(g->timeline_mutex);
  if (!g->timeline) return;
  if (g->tl_negotiating.erase(name) == 0) return;
  g->timeline->End(name, TlNowUs());
}

// Begin/end a span on every tensor of a response. Open-span counts are
// tracked so a timeline started (or stopped) mid-cycle never records
// an unbalanced B/E pair on a lane — the same protection the
// NEGOTIATE spans get from tl_negotiating.
void TlAllBegin(const Response& resp, const std::string& category) {
  std::lock_guard<std::mutex> lk(g->timeline_mutex);
  if (!g->timeline) return;
  long long now = TlNowUs();
  for (auto& nm : resp.tensor_names) {
    ++g->tl_open_spans[nm];
    g->timeline->Begin(nm, category, now);
  }
}

void TlAllEnd(const Response& resp) {
  std::lock_guard<std::mutex> lk(g->timeline_mutex);
  if (!g->timeline) return;
  long long now = TlNowUs();
  for (auto& nm : resp.tensor_names) {
    auto it = g->tl_open_spans.find(nm);
    if (it == g->tl_open_spans.end() || it->second == 0)
      continue;  // span opened before this timeline session
    if (--it->second == 0) g->tl_open_spans.erase(it);
    g->timeline->End(nm, now);
  }
}

// The wire-op activity name (reference analog: MPI_ALLREDUCE /
// NCCL_ALLREDUCE names in common.h:73-105; the transport here is the
// native TCP data plane).
const char* TlWireName(const Response& resp) {
  switch (resp.op_type) {
    case OpType::ALLREDUCE:
      return resp.reduce_op == ReduceOp::ADASUM ? "TCP_ADASUM_ALLREDUCE"
                                                : "TCP_ALLREDUCE";
    case OpType::ALLGATHER: return "TCP_ALLGATHER";
    case OpType::BROADCAST: return "TCP_BCAST";
    case OpType::ALLTOALL: return "TCP_ALLTOALLV";
    case OpType::REDUCESCATTER: return "TCP_REDUCESCATTER";
    default: return "TCP_OP";
  }
}

// ----------------------------------------------------------- executor ------

void ExecuteError(ProcessSetState& ps, const Response& resp) {
  for (auto& name : resp.tensor_names) {
    TensorTableEntry e;
    if (ps.queue.Erase(name, &e) && e.callback)
      e.callback(Status::PreconditionError(resp.error_reason), nullptr, 0,
                 nullptr, 0);
  }
}

Status ExecuteAllreduce(ProcessSetState& ps, const Response& resp) {
  size_t esize = DataTypeSize(resp.dtype);
  int n_members = (int)ps.members.size();
  double avg_scale =
      resp.reduce_op == ReduceOp::AVERAGE ? 1.0 / n_members : 1.0;

  struct Part {
    TensorTableEntry entry;
    bool present;
    int64_t count;
  };
  std::vector<Part> parts;
  int64_t total = 0;
  for (size_t i = 0; i < resp.tensor_names.size(); ++i) {
    Part p;
    p.count = resp.tensor_sizes[i];
    p.present = ps.queue.Erase(resp.tensor_names[i], &p.entry);
    total += p.count;
    parts.push_back(std::move(p));
  }

  // Negotiated wire codec for this cycle (adopted id — see
  // Controller::stage_wire_codec for why it is never read per-rank
  // from the environment here).
  int codec = g->controller ? g->controller->wire_codec() : 0;
  if (codec != g->ef_codec) {
    // Residuals carry the quantization error of a specific encoding;
    // after a codec flip they would inject garbage, so drop them.
    g->ef_residuals.clear();
    g->ef_codec = codec;
  }
  if (codec == CODEC_INT8 && resp.dtype == DataType::FLOAT32 &&
      resp.reduce_op != ReduceOp::ADASUM) {
    // int8 error feedback (docs/wire.md#compression): fold the previous
    // round's quantization error into this submission, then replace the
    // submission with its own quantized round-trip so every rank reduces
    // values that survive the wire exactly, and bank the new error. The
    // user buffer is mutated in place — safe, the allreduce overwrites
    // it with the reduction anyway.
    for (auto& p : parts) {
      if (!p.present || p.count <= 0) continue;
      float* x = (float*)p.entry.data;
      int64_t cnt = p.count;
      std::vector<float>& r = g->ef_residuals[p.entry.name];
      r.resize((size_t)cnt, 0.0f);
      for (int64_t i = 0; i < cnt; ++i) x[i] += r[i];
      std::vector<uint8_t> wire((size_t)CodecWireBytes(CODEC_INT8, cnt));
      std::vector<float> xq((size_t)cnt);
      CodecEncode(CODEC_INT8, x, cnt, wire.data());
      CodecDecodeRange(CODEC_INT8, wire.data(), cnt, 0, cnt, xq.data());
      for (int64_t i = 0; i < cnt; ++i) {
        r[i] = x[i] - xq[i];
        x[i] = xq[i];
      }
    }
  }

  Status st;
  if (resp.reduce_op == ReduceOp::ADASUM) {
    // Adasum coefficients are per-tensor: run the merge tree tensor by
    // tensor (reference: adasum.h FusedAllreduce per-layer dots).
    TlAllBegin(resp, TlWireName(resp));
    for (auto& p : parts) {
      std::vector<char> scratch;
      void* data;
      if (p.present) {
        data = p.entry.data;
      } else {
        scratch.assign((size_t)(p.count * (int64_t)esize), 0);
        data = scratch.data();
      }
      if (resp.prescale != 1.0)
        ScaleBuffer(data, p.count, resp.dtype, resp.prescale);
      st = AdasumAllreduce(g->comm, data, p.count, resp.dtype, ps.members);
      if (!st.ok()) break;
      if (resp.postscale != 1.0)
        ScaleBuffer(data, p.count, resp.dtype, resp.postscale);
    }
    TlAllEnd(resp);
  } else if (parts.size() == 1 && parts[0].present) {
    // Single tensor: reduce in place, no fusion copy.
    Part& p = parts[0];
    if (resp.prescale != 1.0)
      ScaleBuffer(p.entry.data, p.count, resp.dtype, resp.prescale);
    TlAllBegin(resp, TlWireName(resp));
    st = RingAllreduce(g->comm, p.entry.data, p.count, resp.dtype,
                       resp.reduce_op, ps.members, codec);
    TlAllEnd(resp);
    if (st.ok()) {
      double s = avg_scale * resp.postscale;
      if (s != 1.0) ScaleBuffer(p.entry.data, p.count, resp.dtype, s);
    }
  } else if (g->wire_sg) {
    // Fused scatter-gather path (docs/wire.md): describe the tensors
    // as a segment list and ring-reduce straight over their memory —
    // sends gather from (and allgather receives scatter into) tensor
    // buffers via sendmsg/recvmsg, so the MEMCPY_IN/OUT_FUSION_BUFFER
    // pack/unpack of the legacy path below never happens.
    std::vector<std::vector<char>> absent;  // joined ranks contribute 0
    std::vector<WireSegment> segs;
    segs.reserve(parts.size());
    for (auto& p : parts) {
      char* ptr;
      if (p.present) {
        ptr = (char*)p.entry.data;
      } else {
        absent.emplace_back((size_t)(p.count * (int64_t)esize), 0);
        ptr = absent.back().data();
      }
      if (resp.prescale != 1.0)
        ScaleBuffer(ptr, p.count, resp.dtype, resp.prescale);
      segs.push_back({ptr, p.count * (int64_t)esize});
    }
    TlAllBegin(resp, TlWireName(resp));
    st = RingAllreduceSegments(g->comm, segs, total, resp.dtype,
                               resp.reduce_op, ps.members, codec);
    TlAllEnd(resp);
    if (st.ok()) {
      double s = avg_scale * resp.postscale;
      if (s != 1.0)
        for (size_t i = 0; i < parts.size(); ++i)
          ScaleBuffer(segs[i].ptr, parts[i].count, resp.dtype, s);
    }
  } else {
    // Fused path: pack into the persistent fusion buffer
    // (reference: fusion_buffer_manager.h:40, PerformOperation memcpys).
    if ((int64_t)g->fusion_buffer.size() < total * (int64_t)esize)
      g->fusion_buffer.resize((size_t)(total * (int64_t)esize));
    char* buf = g->fusion_buffer.data();
    int64_t off = 0;
    TlAllBegin(resp, "MEMCPY_IN_FUSION_BUFFER");
    for (auto& p : parts) {
      if (p.present) {
        memcpy(buf + off * esize, p.entry.data, (size_t)(p.count * esize));
      } else {
        memset(buf + off * esize, 0, (size_t)(p.count * esize));
      }
      off += p.count;
    }
    TlAllEnd(resp);
    if (resp.prescale != 1.0)
      ScaleBuffer(buf, total, resp.dtype, resp.prescale);
    TlAllBegin(resp, TlWireName(resp));
    st = RingAllreduce(g->comm, buf, total, resp.dtype, resp.reduce_op,
                       ps.members, codec);
    TlAllEnd(resp);
    if (st.ok()) {
      double s = avg_scale * resp.postscale;
      if (s != 1.0) ScaleBuffer(buf, total, resp.dtype, s);
      off = 0;
      TlAllBegin(resp, "MEMCPY_OUT_FUSION_BUFFER");
      for (auto& p : parts) {
        if (p.present)
          memcpy(p.entry.data, buf + off * esize,
                 (size_t)(p.count * esize));
        off += p.count;
      }
      TlAllEnd(resp);
    }
  }
  for (auto& p : parts) {
    if (p.present && p.entry.callback)
      p.entry.callback(st, p.entry.data, p.count * (int64_t)esize, nullptr,
                       0);
  }
  return st;
}

Status ExecuteAllgather(ProcessSetState& ps, const Response& resp) {
  const std::string& name = resp.tensor_names[0];
  TensorTableEntry e;
  bool present = ps.queue.Erase(name, &e);
  size_t esize = DataTypeSize(resp.dtype);
  size_t n = ps.members.size();

  std::vector<int64_t> bytes(n);
  int64_t total_bytes = 0;
  for (size_t i = 0; i < n; ++i) {
    bytes[i] = resp.tensor_sizes[i] * (int64_t)esize;
    total_bytes += bytes[i];
  }
  std::vector<char> out((size_t)total_bytes);
  const void* send = present ? e.data : nullptr;
  TlAllBegin(resp, TlWireName(resp));
  Status st = RingAllgatherv(g->comm, send, out.data(), bytes, ps.members);
  TlAllEnd(resp);
  if (present && e.callback) {
    // splits: per-member element counts (python derives dim 0).
    e.callback(st, out.data(), total_bytes, resp.tensor_sizes.data(),
               (int)n);
  }
  return st;
}

Status ExecuteBroadcast(ProcessSetState& ps, const Response& resp) {
  const std::string& name = resp.tensor_names[0];
  TensorTableEntry e;
  bool present = ps.queue.Erase(name, &e);
  size_t esize = DataTypeSize(resp.dtype);
  int64_t bytes = resp.tensor_sizes[0] * (int64_t)esize;
  int root_idx = ps.member_index(resp.root_rank);
  if (root_idx < 0)
    return Status::InvalidArgument("broadcast root not in process set");
  std::vector<char> scratch;
  void* data;
  if (present) {
    data = e.data;
  } else {
    scratch.resize((size_t)bytes);
    data = scratch.data();
  }
  TlAllBegin(resp, TlWireName(resp));
  Status st = BroadcastData(g->comm, data, bytes, root_idx, ps.members);
  TlAllEnd(resp);
  if (present && e.callback)
    e.callback(st, data, bytes, nullptr, 0);
  return st;
}

Status ExecuteAlltoall(ProcessSetState& ps, const Response& resp) {
  const std::string& name = resp.tensor_names[0];
  TensorTableEntry e;
  bool present = ps.queue.Erase(name, &e);
  size_t esize = DataTypeSize(resp.dtype);
  size_t n = ps.members.size();
  int my_idx = ps.member_index(g->comm.rank());

  std::vector<int64_t> send_bytes(n), recv_bytes(n);
  int64_t total_recv = 0;
  for (size_t j = 0; j < n; ++j) {
    send_bytes[j] = resp.tensor_sizes[(size_t)my_idx * n + j] * (int64_t)esize;
    recv_bytes[j] = resp.tensor_sizes[j * n + (size_t)my_idx] * (int64_t)esize;
    total_recv += recv_bytes[j];
  }
  std::vector<char> out((size_t)total_recv);
  const void* send = present ? e.data : nullptr;
  TlAllBegin(resp, TlWireName(resp));
  Status st =
      AlltoallvData(g->comm, send, send_bytes, out.data(), recv_bytes,
                    ps.members);
  TlAllEnd(resp);
  if (present && e.callback) {
    std::vector<int64_t> recv_counts(n);
    for (size_t j = 0; j < n; ++j)
      recv_counts[j] = recv_bytes[j] / (int64_t)esize;
    e.callback(st, out.data(), total_recv, recv_counts.data(), (int)n);
  }
  return st;
}

Status ExecuteReducescatter(ProcessSetState& ps, const Response& resp) {
  // Reduce + local shard extraction. The shard split follows the ring
  // chunking convention: dim-0-balanced contiguous shards by member index.
  const std::string& name = resp.tensor_names[0];
  TensorTableEntry e;
  bool present = ps.queue.Erase(name, &e);
  size_t esize = DataTypeSize(resp.dtype);
  int64_t count = resp.tensor_sizes[0];
  int n = (int)ps.members.size();
  int my_idx = ps.member_index(g->comm.rank());

  std::vector<char> scratch;
  void* data;
  if (present) {
    data = e.data;
  } else {
    scratch.assign((size_t)(count * (int64_t)esize), 0);
    data = scratch.data();
  }
  TlAllBegin(resp, TlWireName(resp));
  Status st = RingAllreduce(g->comm, data, count, resp.dtype, resp.reduce_op,
                            ps.members,
                            g->controller ? g->controller->wire_codec() : 0);
  TlAllEnd(resp);
  if (st.ok() && resp.reduce_op == ReduceOp::AVERAGE)
    ScaleBuffer(data, count, resp.dtype, 1.0 / n);
  if (present && e.callback) {
    // Shard on dim 0 elements — callback gets (ptr, bytes) of my shard.
    int64_t rows = e.shape.dims.empty() ? count : e.shape.dims[0];
    int64_t slice = count / (rows ? rows : 1);
    int64_t base_rows = rows / n, extra = rows % n;
    int64_t my_rows = base_rows + (my_idx < extra ? 1 : 0);
    int64_t start_row = (int64_t)my_idx * base_rows +
                        std::min<int64_t>(my_idx, extra);
    e.callback(st, (char*)data + start_row * slice * (int64_t)esize,
               my_rows * slice * (int64_t)esize, nullptr, 0);
  }
  return st;
}

void CreateProcessSetLocked(int ps_id, const std::vector<int>& ranks);

Status ExecuteBarrier(ProcessSetState& ps, const Response& resp) {
  const std::string& name = resp.tensor_names[0];
  TensorTableEntry e;
  bool present = ps.queue.Erase(name, &e);
  Status st = g->comm.Barrier(ps.coordinator(), ps.members);

  // Dynamic process-set registration rides the barrier mechanism: the
  // member list travels in the entry's splits (reference analog:
  // ProcessSetTable::InitializeRegisteredAndRemoveMarkedIfReady,
  // horovod/common/process_set.h:105-114).
  if (st.ok() && present && name.rfind("__ps_add__", 0) == 0) {
    std::vector<int> ranks(e.splits.begin(), e.splits.end());
    int new_id = (int)e.root_rank;
    std::lock_guard<std::mutex> lk(g->ps_mutex);
    CreateProcessSetLocked(new_id, ranks);
  } else if (st.ok() && present && name.rfind("__ps_remove__", 0) == 0) {
    int dead_id = (int)e.root_rank;
    std::lock_guard<std::mutex> lk(g->ps_mutex);
    g->pending_removals.push_back(dead_id);
  }
  if (present && e.callback) e.callback(st, nullptr, 0, nullptr, 0);
  return st;
}

void ExecuteJoin(ProcessSetState& ps, const Response& resp) {
  ps.joined_locally = false;
  ps.queue.Erase("__join__", nullptr);
  long long tag = -1;
  {
    std::lock_guard<std::mutex> lk(g->join_mutex);
    auto it = g->join_tags.find(ps.id);
    if (it != g->join_tags.end()) {
      tag = it->second;
      g->join_tags.erase(it);
    }
  }
  if (tag >= 0) {
    int64_t last = resp.root_rank;
    FireCallback(tag, Status::OK(), &last, sizeof(last), nullptr, 0);
  }
}

Status PerformOperation(ProcessSetState& ps, const Response& resp,
                        bool from_cache) {
  Status st;
  if (DevicePlaneOwns(resp)) {  // card tensors: never the TCP ring
    st = DevicePlaneExecute(ps, resp, g->controller->wire_codec(),
                            g->controller->hierarchical());
  } else switch (resp.op_type) {
    case OpType::ERROR_OP:
      ExecuteError(ps, resp);
      return Status::OK();
    case OpType::ALLREDUCE:
      st = ExecuteAllreduce(ps, resp);
      break;
    case OpType::ALLGATHER:
      st = ExecuteAllgather(ps, resp);
      break;
    case OpType::BROADCAST:
      st = ExecuteBroadcast(ps, resp);
      break;
    case OpType::ALLTOALL:
      st = ExecuteAlltoall(ps, resp);
      break;
    case OpType::REDUCESCATTER:
      st = ExecuteReducescatter(ps, resp);
      break;
    case OpType::BARRIER:
      st = ExecuteBarrier(ps, resp);
      break;
    case OpType::JOIN:
      ExecuteJoin(ps, resp);
      return Status::OK();
  }
  // Populate the cache after a successful uncached allreduce/broadcast
  // (fixed-signature ops; allgather/alltoall sizes vary per step).
  if (st.ok() && !from_cache &&
      (resp.op_type == OpType::ALLREDUCE ||
       resp.op_type == OpType::BROADCAST)) {
    for (size_t i = 0; i < resp.tensor_names.size(); ++i) {
      Request sig;
      sig.tensor_name = resp.tensor_names[i];
      sig.op_type = resp.op_type;
      sig.reduce_op = resp.reduce_op;
      sig.dtype = resp.dtype;
      sig.root_rank = resp.root_rank;
      sig.prescale = resp.prescale;
      sig.postscale = resp.postscale;
      sig.shape.dims = {resp.tensor_sizes[i]};  // flattened signature
      Response single;
      single.op_type = resp.op_type;
      single.reduce_op = resp.reduce_op;
      single.dtype = resp.dtype;
      single.root_rank = resp.root_rank;
      single.prescale = resp.prescale;
      single.postscale = resp.postscale;
      single.tensor_names = {resp.tensor_names[i]};
      single.tensor_sizes = {resp.tensor_sizes[i]};
      ps.cache.Put(sig, single);
    }
  }
  return st;
}

// ------------------------------------------------- process set management ---

void CreateProcessSetLocked(int ps_id, const std::vector<int>& ranks) {
  // analysis: holds-lock(ps_mutex) — the Locked suffix is the
  // contract: every caller acquires g->ps_mutex first.
  if (g->process_sets.count(ps_id)) return;
  auto ps = std::make_unique<ProcessSetState>();
  ps->id = ps_id;
  ps->members = ranks;
  std::sort(ps->members.begin(), ps->members.end());
  ps->cache.SetCapacity((size_t)g->cache_cap);
  g->process_sets.emplace(ps_id, std::move(ps));
}

// -------------------------------------------------------- background loop ---

void BackgroundLoop() {
  // Pin the coordination thread when asked (reference:
  // horovod/common/common.cc SetAffinity via HOROVOD_THREAD_AFFINITY).
#ifdef __linux__
  if (const char* env = getenv("HOROVOD_THREAD_AFFINITY")) {
    if (*env) {
      const char* lr = getenv("HOROVOD_LOCAL_RANK");
      int cpu = atoi(env) + (lr ? atoi(lr) : 0);
      cpu_set_t set;
      CPU_ZERO(&set);
      CPU_SET(cpu % CPU_SETSIZE, &set);
      pthread_setaffinity_np(pthread_self(), sizeof(set), &set);
    }
  }
#endif
  auto last_cycle = Clock::now();
  while (!g->shut_down.load()) {
    // Maintain the cycle cadence (reference: RunLoopOnce sleep,
    // operations.cc:689-697).
    auto target = last_cycle + std::chrono::duration_cast<Clock::duration>(
                                   std::chrono::duration<double, std::milli>(
                                       g->cycle_ms));
    auto now = Clock::now();
    if (now < target) std::this_thread::sleep_for(target - now);
    last_cycle = Clock::now();

    {
      // tl_mark_cycles is written under timeline_mutex by the
      // start/stop API; read it under the same lock.
      std::lock_guard<std::mutex> tlk(g->timeline_mutex);
      if (g->tl_mark_cycles && g->timeline)
        g->timeline->Event("CYCLE_START", "cycle", TlNowUs(), 0);
    }

    std::vector<ProcessSetState*> sets;
    {
      std::lock_guard<std::mutex> lk(g->ps_mutex);
      for (auto& kv : g->process_sets) sets.push_back(kv.second.get());
    }
    for (auto* ps : sets) {
      // Membership: ranks outside a set skip its negotiation entirely;
      // concurrent sets are safe because every member processes sets in
      // the same (id-sorted) order on the one background thread.
      if (ps->member_index(g->comm.rank()) < 0) continue;
      std::vector<Response> responses;
      size_t n_cached = 0;
      auto neg_start = Clock::now();
      Status s = g->controller->ComputeResponseList(*ps, &responses,
                                                    &n_cached);
      {
        std::lock_guard<std::mutex> tlk(g->timeline_mutex);
        if (g->timeline && !responses.empty()) {
          auto us = [&](Clock::time_point t) {
            return (long long)std::chrono::duration_cast<
                       std::chrono::microseconds>(t - g->t_origin)
                .count();
          };
          g->timeline->Event("NEGOTIATE", "negotiate", us(neg_start),
                             us(Clock::now()) - us(neg_start));
        }
      }
      if (!s.ok()) {
        // A connection error while every queue is idle is the normal
        // signature of a peer exiting cleanly (each cycle does a network
        // round even with no work): stop coordinating quietly instead of
        // declaring failure with nothing to fail. PRECONDITION_ERROR is
        // exempt — it carries a deliberate enforcement decision (stall
        // shutdown) that must cascade loudly even from an idle
        // coordinator.
        bool idle = s.type != StatusType::PRECONDITION_ERROR;
        for (auto* other : sets)
          if (other->queue.pending_count() > 0) idle = false;
        if (idle) {
          HVD_LOG(LogLevel::DEBUG,
                  "peer closed during idle cycle; stopping coordination");
          g->shut_down.store(true);
          g->comm.Abort();
          break;
        }
        HVD_LOG(LogLevel::ERROR,
                "coordination failed: " + s.reason + "; failing pending ops");
        // Evidence before error: the abort transition is recorded and
        // the ring dumped while the events leading here are still in
        // it (docs/flightrec.md).
        FlightRec(FrKind::ABORT, (long long)s.type, 0, 0, s.reason.c_str());
        FlightRecAutoDump(s.reason.c_str());
        g->failed.store(true);
        // Cascade: break every connection so peers blocked in this
        // cycle's gather/bcast fail immediately instead of hanging
        // (the role NCCL's async-error abort plays in the reference,
        // nccl_operations.cc:109-122). Elastic recovery restarts the
        // whole communicator anyway.
        g->ctr_aborts++;
        g->comm.Abort();
        for (auto* other : sets)
          other->queue.AbortAll(s);
        break;
      }
      // Top-level per-tensor spans open as soon as the response list is
      // known; QUEUE covers the wait behind earlier responses in the
      // same cycle (reference: Timeline::Start + QUEUE activity).
      for (auto& r : responses) {
        TlAllBegin(r, OpTypeName(r.op_type));
        TlAllBegin(r, "QUEUE");
      }
      long long cycle_bytes = 0;
      bool cascaded = false;
      for (size_t i = 0; i < responses.size(); ++i) {
        bool from_cache = i < n_cached;
        g->ctr_responses++;
        if (from_cache) g->ctr_cached_responses++;
        if (responses[i].op_type == OpType::ALLREDUCE) {
          size_t nt = responses[i].tensor_names.size();
          g->ctr_allreduced_tensors += (long long)nt;
          if (nt > 1) g->ctr_fused_tensors += (long long)nt;
          long long bytes = 0;
          for (auto c : responses[i].tensor_sizes)
            bytes += c * (long long)DataTypeSize(responses[i].dtype);
          g->ctr_allreduce_bytes += bytes;
          cycle_bytes += bytes;
        }
        // Cross-rank collective sequence number: every member executes
        // this set's responses in the same coordinator-decided order on
        // its single background thread, so the per-set counter agrees
        // across ranks — the divergence axis tools/trace aligns on.
        long long seq = ps->exec_seq++;
        long long resp_bytes = 0;
        for (auto cnt : responses[i].tensor_sizes)
          resp_bytes += cnt * (long long)DataTypeSize(responses[i].dtype);
        const std::string first_name = responses[i].tensor_names.empty()
                                           ? std::string()
                                           : responses[i].tensor_names[0];
        FlightRecSetContext(ps->id, seq);
        FlightRec(FrKind::RESP_BEGIN, (long long)responses[i].op_type,
                  (long long)responses[i].tensor_names.size(), resp_bytes,
                  first_name.c_str());
        auto op_start = Clock::now();
        TlAllEnd(responses[i]);  // QUEUE over: execution starts
        Status es = PerformOperation(*ps, responses[i], from_cache);
        TlAllEnd(responses[i]);  // top-level span
        FlightRec(FrKind::RESP_END, (long long)es.type, 0, 0,
                  first_name.c_str());
        FlightRecSetContext(0, -1);
        {
          std::lock_guard<std::mutex> tlk(g->timeline_mutex);
          if (g->timeline) {
            auto us = [&](Clock::time_point t) {
              return (long long)std::chrono::duration_cast<
                         std::chrono::microseconds>(t - g->t_origin)
                  .count();
            };
            std::string nm = responses[i].tensor_names.empty()
                                 ? std::string("op")
                                 : responses[i].tensor_names[0];
            if (responses[i].tensor_names.size() > 1)
              nm += "(+" +
                    std::to_string(responses[i].tensor_names.size() - 1) +
                    " fused)";
            g->timeline->Event(nm, OpTypeName(responses[i].op_type),
                               us(op_start),
                               us(Clock::now()) - us(op_start), seq);
          }
        }
        if (!es.ok()) {
          HVD_LOG(LogLevel::ERROR, "collective failed: " + es.reason);
          if (es.is_comm_failure()) {
            FlightRec(FrKind::ABORT, (long long)es.type, 0, 0,
                      es.reason.c_str());
            FlightRecAutoDump(es.reason.c_str());
          }
          g->failed.store(true);
          // A comm-level execution failure (peer closed, progress
          // deadline) means some peer is dead or wedged mid-transfer:
          // cascade immediately so every rank blocked in this ring step
          // (and every queued op) fails with a typed error instead of
          // waiting for the next negotiation round to discover it.
          if (es.is_comm_failure()) {
            g->ctr_aborts++;
            g->comm.Abort();
            for (auto* other : sets)
              other->queue.AbortAll(es);
            cascaded = true;
            break;
          }
        }
      }
      if (cascaded) break;
      // Autotune scores coordinator-observed payload bytes per wall
      // second (reference: parameter_manager.cc Update).
      if (cycle_bytes > 0 && ps->is_coordinator(g->comm.rank())) {
        std::lock_guard<std::mutex> alk(g->autotune_mutex);
        if (g->autotune) {
          double now_s = std::chrono::duration_cast<
                             std::chrono::duration<double>>(
                             Clock::now() - g->t_origin)
                             .count();
          g->autotune->Record(cycle_bytes, now_s);
        }
      }
    }
    {
      // Snapshot-then-act: move the dead sets OUT under ps_mutex,
      // abort them after it is released. AbortAll fires the enqueuers'
      // done callbacks (the ctypes trampoline — arbitrary Python that
      // may call right back into hvd_core_enqueue, which takes
      // ps_mutex); firing them under ps_mutex is a self-deadlock on a
      // non-recursive mutex.
      std::vector<std::unique_ptr<ProcessSetState>> dead_sets;
      {
        std::lock_guard<std::mutex> lk(g->ps_mutex);
        for (int dead : g->pending_removals) {
          auto it = g->process_sets.find(dead);
          if (it != g->process_sets.end()) {
            dead_sets.push_back(std::move(it->second));
            g->process_sets.erase(it);
          }
        }
        g->pending_removals.clear();
      }
      for (auto& ps : dead_sets)
        ps->queue.AbortAll(Status::Aborted("process set removed"));
    }
  }
  // Drain: fail anything still pending (outside ps_mutex, same
  // callback-reentrancy hazard as above).
  std::vector<std::unique_ptr<ProcessSetState>> remaining;
  {
    std::lock_guard<std::mutex> lk(g->ps_mutex);
    for (auto& kv : g->process_sets)
      remaining.push_back(std::move(kv.second));
    g->process_sets.clear();
  }
  for (auto& ps : remaining)
    ps->queue.AbortAll(Status::Aborted("horovod_tpu core shut down"));
}

}  // namespace
}  // namespace hvd

// ------------------------------------------------------------------ C ABI ---

using namespace hvd;

extern "C" {

// Serializes the online tuner's off-thread wire-param applies against
// the core lifecycle. The tuner thread (utils/online_tuner.py) calls
// hvd_core_set_wire_params while an elastic reset may be tearing the
// core down (`delete g`) or re-Initing it (fds_.assign reallocates the
// vector set_socket_buf_bytes walks) on the main thread — without the
// mutex that is a use-after-free. Only this API pays the lock: it is
// the one entry point designed to be called from a non-owner thread
// for the core's whole lifetime.
static std::mutex g_wire_params_mutex;

int hvd_core_init(int rank, int size, const char* ctrl_addr, int ctrl_port,
                  double cycle_ms, long long fusion_bytes, int cache_cap) {
  if (g) return -1;
  // Exclude a concurrent tuner-thread hvd_core_set_wire_params while
  // g is half-built and comm.Init reallocates fds_ (elastic re-init
  // races the tuner thread that survived the previous world).
  // Released once the comm is fully bootstrapped.
  std::unique_lock<std::mutex> wire_lk(g_wire_params_mutex);
  g = new Global();
  g->rank = rank;
  g->size = size;
  FlightRecSetRank(rank);
  g->cycle_ms = cycle_ms > 0 ? cycle_ms : 1.0;
  if (const char* mc = getenv("HOROVOD_TIMELINE_MARK_CYCLES")) {
    // No other thread can hold g yet, but the discipline (and the
    // locks checker) is uniform: tl_mark_cycles moves under its mutex.
    std::lock_guard<std::mutex> lk(g->timeline_mutex);
    g->tl_mark_cycles = *mc && strcmp(mc, "0") != 0;
  }
  if (const char* sg = getenv("HVD_WIRE_SG"))
    g->wire_sg = !(*sg && strcmp(sg, "0") == 0);
  if (fusion_bytes > 0) g->fusion_bytes = fusion_bytes;
  if (cache_cap >= 0) g->cache_cap = cache_cap;

  // analysis: blocking-ok(init-time bootstrap: the socket dial/accept
  // must complete under g_wire_params_mutex — releasing it earlier
  // would let the tuner thread walk fds_ mid-reallocation. Nothing
  // else contends: the only other taker is set_wire_params, which is
  // exactly the caller being excluded)
  Status s = g->comm.Init(rank, size, ctrl_addr ? ctrl_addr : "127.0.0.1",
                          ctrl_port);
  if (!s.ok()) {
    HVD_LOG(LogLevel::ERROR, "core init failed: " + s.reason);
    delete g;
    g = nullptr;
    return -2;
  }
  wire_lk.unlock();  // comm fully bootstrapped: fds_ is stable now
  g->controller = std::make_unique<Controller>(g->comm, g->fusion_bytes);
  {
    TimelineHooks hooks;
    hooks.negotiate_start = TlNegotiateStart;
    hooks.negotiate_rank_ready = TlNegotiateRankReady;
    hooks.negotiate_end = TlNegotiateEnd;
    g->controller->set_timeline_hooks(std::move(hooks));
  }
  {
    std::lock_guard<std::mutex> lk(g->ps_mutex);
    std::vector<int> world(size);
    for (int i = 0; i < size; ++i) world[(size_t)i] = i;
    CreateProcessSetLocked(0, world);
  }
  g->background = std::thread(BackgroundLoop);
  return 0;
}

void hvd_core_timeline_stop();  // defined below; used during shutdown

void hvd_core_shutdown() {
  // Excludes a concurrent hvd_core_set_wire_params (tuner thread):
  // Close() recycles fds another thread could be setsockopt-ing and
  // the delete frees the comm it dereferences. set_wire_params never
  // blocks on the background thread, so holding the mutex across the
  // join cannot deadlock.
  std::lock_guard<std::mutex> lk(g_wire_params_mutex);
  if (!g) return;
  // analysis: blocking-ok(teardown: the writer-thread join inside
  // timeline_stop and the background join below must both complete
  // under g_wire_params_mutex so a concurrent set_wire_params cannot
  // touch the comm being closed; neither joined thread ever takes
  // this mutex, so the join cannot deadlock)
  hvd_core_timeline_stop();
  g->shut_down.store(true);
  // Unblock the background thread if it is parked in a socket op (e.g. a
  // peer died mid-negotiation) so the join below cannot deadlock.
  g->comm.Abort();
  // analysis: blocking-ok(see teardown note above — the background
  // thread never takes g_wire_params_mutex)
  if (g->background.joinable()) g->background.join();
  g->comm.Close();
  delete g;
  g = nullptr;
}

void hvd_core_set_callback(void (*cb)(long long, int, const char*,
                                      const void*, long long,
                                      const long long*, int)) {
  if (g) g->callback = (DoneCb)cb;
}

int hvd_core_enqueue(long long tag, int op_type, const char* name, int dtype,
                     void* data, const long long* shape, int ndim,
                     int root_rank, double prescale, double postscale,
                     int ps_id, int reduce_op, const long long* splits,
                     int nsplits, long long group_id) {
  if (!g) return -1;
  // After the loop stopped (peer exit / failure) nothing will ever pop
  // the queue again — fail fast instead of letting the caller hang.
  if (g->shut_down.load() || g->failed.load()) return -5;
  ProcessSetState* ps;
  {
    std::lock_guard<std::mutex> lk(g->ps_mutex);
    auto it = g->process_sets.find(ps_id);
    if (it == g->process_sets.end()) return -3;
    ps = it->second.get();
  }
  TensorTableEntry e;
  e.name = name;
  e.op_type = (OpType)op_type;
  e.reduce_op = (ReduceOp)reduce_op;
  e.dtype = (DataType)dtype;
  for (int i = 0; i < ndim; ++i) e.shape.dims.push_back(shape[i]);
  e.data = data;
  e.root_rank = root_rank;
  e.prescale = prescale;
  e.postscale = postscale;
  for (int i = 0; i < nsplits; ++i) e.splits.push_back(splits[i]);
  e.group_id = group_id;
  e.process_set_id = ps_id;
  e.callback = MakeDone(tag);

  Request req;
  req.request_rank = g->rank;
  req.op_type = e.op_type;
  req.reduce_op = e.reduce_op;
  req.dtype = e.dtype;
  req.tensor_name = e.name;
  req.shape = e.shape;
  req.root_rank = e.root_rank;
  req.prescale = e.prescale;
  req.postscale = e.postscale;
  req.splits = e.splits;
  req.group_id = e.group_id;

  FlightRec(FrKind::ENQUEUE, op_type, ps_id, 0, name);
  Status s = ps->queue.Add(std::move(e), req);
  if (!s.ok()) {
    FireCallback(tag, s);
    return -4;
  }
  // Close the TOCTOU with the loop's exit drain: if shutdown/failure
  // landed after the fail-fast check above, the background thread may
  // already have run its final AbortAll and will never pop this op.
  // Draining here makes the op's callback fire (entries abort exactly
  // once — the queue pops under its own lock), so the caller's future
  // resolves with the same HorovodInternalError it would have gotten
  // from the fail-fast path instead of hanging forever.
  if (g->shut_down.load() || g->failed.load())
    ps->queue.AbortAll(Status::Aborted("horovod_tpu core is shut down"));
  return 0;
}

int hvd_core_join(long long tag, int ps_id) {
  if (!g) return -1;
  ProcessSetState* ps;
  {
    std::lock_guard<std::mutex> lk(g->ps_mutex);
    auto it = g->process_sets.find(ps_id);
    if (it == g->process_sets.end()) return -3;
    ps = it->second.get();
  }
  {
    std::lock_guard<std::mutex> lk(g->join_mutex);
    g->join_tags[ps_id] = tag;
  }
  TensorTableEntry e;
  e.name = "__join__";
  e.op_type = OpType::JOIN;
  Request req;
  req.request_rank = g->rank;
  req.op_type = OpType::JOIN;
  req.tensor_name = e.name;
  Status s = ps->queue.Add(std::move(e), req);
  return s.ok() ? 0 : -4;
}

int hvd_core_rank() { return g ? g->rank : -1; }
int hvd_core_size() { return g ? g->size : -1; }
int hvd_core_failed() { return g && g->failed.load() ? 1 : 0; }

// Online-tuner wire knobs (utils/online_tuner.py, docs/autotune.md):
// ring sub-chunk size takes effect on the next ring step (atomic,
// read per op), socket buffers resize live fds and pin an override
// for sockets connected later. -1 = leave that knob unchanged (0 is
// meaningful for both: serial ring schedule / kernel-autotuned bufs).
void hvd_core_set_wire_params(long long ring_chunk_bytes,
                              long long socket_buf_bytes) {
  std::lock_guard<std::mutex> lk(g_wire_params_mutex);
  if (!g) return;
  if (ring_chunk_bytes >= 0) g->comm.set_ring_chunk_bytes(ring_chunk_bytes);
  if (socket_buf_bytes >= 0) g->comm.set_socket_buf_bytes(socket_buf_bytes);
}

void hvd_core_set_params(double cycle_ms, long long fusion_bytes) {
  if (!g) return;
  if (cycle_ms > 0) g->cycle_ms = cycle_ms;
  if (fusion_bytes > 0 && g->controller) {
    g->fusion_bytes = fusion_bytes;
    // Staged: takes effect when the coordinator broadcasts it (keeps
    // fusion layouts rank-identical; see controller.h).
    g->controller->stage_fusion_threshold(fusion_bytes);
  }
}

// Native Bayesian autotuner (reference: parameter_manager.cc:28-66).
// Runs on the coordinator; fusion-threshold changes are staged through
// the controller broadcast, cycle-time changes apply locally.
int hvd_core_autotune_start(const char* log_path) {
  if (!g) return -1;
  std::lock_guard<std::mutex> alk(g->autotune_mutex);
  if (g->autotune) return -1;
  double fusion_mb = (double)g->fusion_bytes / (1024.0 * 1024.0);
  g->autotune.reset(new ParameterManager(
      fusion_mb, g->cycle_ms,
      [](long long fusion_bytes, double cycle_ms, bool cache_enabled,
         bool hierarchical) {
        if (!g) return;
        g->cycle_ms = cycle_ms;
        g->fusion_bytes = fusion_bytes;
        if (g->controller) {
          g->controller->stage_fusion_threshold(fusion_bytes);
          g->controller->stage_categoricals(cache_enabled, hierarchical);
        }
      },
      log_path ? log_path : ""));
  return 0;
}

// out[0]=fusion_mb out[1]=cycle_ms out[2]=done out[3]=samples
// out[4]=cache_enabled out[5]=hierarchical out[6]=categorical_samples
void hvd_core_autotune_state(double* out, int n) {
  if (!g || !out) return;
  std::lock_guard<std::mutex> alk(g->autotune_mutex);
  if (!g->autotune) return;
  double vals[7] = {g->autotune->fusion_mb(), g->autotune->cycle_ms(),
                    g->autotune->done() ? 1.0 : 0.0,
                    (double)g->autotune->samples(),
                    g->autotune->cache_enabled() ? 1.0 : 0.0,
                    g->autotune->hierarchical() ? 1.0 : 0.0,
                    (double)g->autotune->categorical_samples()};
  for (int i = 0; i < n && i < 7; ++i) out[i] = vals[i];
}

// Native chrome-trace timeline of the background loop
// (reference: timeline.cc TimelineWriter; dynamic start/stop analog of
// horovod_start_timeline, operations.cc:1011-1041).
int hvd_core_timeline_start(const char* path, int mark_cycles) {
  if (!g || !path) return -1;
  std::lock_guard<std::mutex> lk(g->timeline_mutex);
  if (g->timeline) return -2;
  g->timeline.reset(new TimelineWriter(path, g->rank));
  // OR with the env default: either surface can turn marks on.
  if (mark_cycles) g->tl_mark_cycles = true;
  return 0;
}

void hvd_core_timeline_stop() {
  if (!g) return;
  std::unique_ptr<TimelineWriter> dead;
  {
    std::lock_guard<std::mutex> lk(g->timeline_mutex);
    dead = std::move(g->timeline);
    // A later start must not inherit phase state from this session
    // (stale entries would suppress fresh NEGOTIATE begins or close
    // spans the new session never opened). Cycle marks reset to the
    // env default; the next start's argument can re-enable them.
    g->tl_negotiating.clear();
    g->tl_open_spans.clear();
    const char* mc = getenv("HOROVOD_TIMELINE_MARK_CYCLES");
    g->tl_mark_cycles = mc && *mc && strcmp(mc, "0") != 0;
  }
  if (dead) dead->Stop();
}

// Live controller-side categorical state (what the staged broadcast
// actually adopted, as opposed to what the autotuner proposed).
int hvd_core_cache_enabled() {
  return g && g->controller && g->controller->cache_enabled() ? 1 : 0;
}
int hvd_core_hierarchical() {
  return g && g->controller && g->controller->hierarchical() ? 1 : 0;
}

// Stage a wire codec (WireCodecId: 0=none 1=bf16 2=fp16 3=int8) for the
// coordinator to adopt and broadcast at its next slow-path round — the
// same staged discipline as hvd_core_set_fusion_bytes, so every rank
// flips codecs in the same negotiation cycle. Returns 0, -1 without a
// live core, -2 for an out-of-range id.
int hvd_core_stage_codec(int codec) {
  if (!g || !g->controller) return -1;
  if (codec < 0 || codec > kCodecMax) return -2;
  g->controller->stage_wire_codec(codec);
  return 0;
}

// Currently *adopted* wire codec id (-1 without a live core). Staged
// values do not show here until the coordinator broadcasts them.
int hvd_core_wire_codec() {
  return g && g->controller ? g->controller->wire_codec() : -1;
}

// 1 while the background loop coordinates; 0 before init, after
// shutdown, and once the loop stopped on its own: a peer closed during an
// idle cycle, or a failure cascaded. The Python side's failure watch
// polls it to abort the process groups that a dead peer would hang.
int hvd_core_running() {
  return g && !g->shut_down.load() && !g->failed.load() ? 1 : 0;
}

double hvd_core_cycle_ms() { return g ? g->cycle_ms : 0.0; }
long long hvd_core_fusion_bytes() {
  return g ? (long long)g->fusion_bytes : 0;
}

// Fills out[0..n): responses, cached_responses, fused_tensors,
// allreduced_tensors, allreduce_bytes, comm_timeouts, aborts,
// bootstrap_retries, tx_bytes, rx_bytes, ring_subchunk_steps,
// flightrec_events, flightrec_dropped, flightrec_dumps, reconnects,
// frames_retransmitted, reconnect_failures, codec_saved_bytes,
// codec_bf16_sends, codec_fp16_sends, codec_int8_sends,
// retx_rings_clamped. Callers pass the slot count they know about, so
// the layout is append-only.
void hvd_core_counters(long long* out, int n) {
  if (!g || !out) return;
  long long vals[22] = {
      g->ctr_responses.load(), g->ctr_cached_responses.load(),
      g->ctr_fused_tensors.load(), g->ctr_allreduced_tensors.load(),
      g->ctr_allreduce_bytes.load(), CommTimeoutsTotal(),
      g->ctr_aborts.load(), CommBootstrapRetriesTotal(),
      CommTxBytesTotal(), CommRxBytesTotal(), RingSubchunkStepsTotal(),
      FlightRecEventsTotal(), FlightRecDroppedTotal(),
      FlightRecDumpsTotal(), CommReconnectsTotal(),
      CommFramesRetransmittedTotal(), CommReconnectFailuresTotal(),
      CodecSavedBytesTotal(), CodecSendsTotal(CODEC_BF16),
      CodecSendsTotal(CODEC_FP16), CodecSendsTotal(CODEC_INT8),
      CommRetxRingsClampedTotal()};
  for (int i = 0; i < n && i < 22; ++i) out[i] = vals[i];
}

// Self-healing-wire heal-duration stats (docs/wire.md#reconnect):
// out[0]=reconnects out[1]=frames_retransmitted out[2]=failures
// out[3]=last_heal_us out[4]=max_heal_us. bench_wire --fault uses
// these for the recovery-latency (break -> resumed stream) number.
void hvd_wire_reconnect_stats(long long* out, int n) {
  if (!out) return;
  long long last_us = 0, max_us = 0;
  if (g) g->comm.reconnect_stats(&last_us, &max_us);
  long long vals[5] = {CommReconnectsTotal(),
                       CommFramesRetransmittedTotal(),
                       CommReconnectFailuresTotal(), last_us, max_us};
  for (int i = 0; i < n && i < 5; ++i) out[i] = vals[i];
}

// --- flight recorder (docs/flightrec.md) ------------------------------------

// Serialize the native event ring to `path` as JSONL. Works with or
// without a live core (the ring is process-global); returns the event
// count written, or -1 when the recorder is disabled / the write
// failed. hvd.dump_flight_record() and the abort auto-dump use it.
int hvd_core_flightrec_dump(const char* path) {
  return FlightRecDump(path);
}

// Test hooks (tests/test_flightrec.py): record a synthetic event /
// reinitialize the ring with a chosen capacity. Not part of the
// session API; FlightRecReset is not safe against concurrent
// producers (unit-test use only).
void hvd_flightrec_record(int kind, long long a, long long b, long long c,
                          const char* name) {
  FlightRec((FrKind)kind, a, b, c, name);
}

void hvd_flightrec_reset(long long capacity) { FlightRecReset(capacity); }

// --- wire-schedule test hooks (tests/test_wire.py) --------------------------
// Pure functions over the ring math in collectives.cc, exported so the
// chunk/offset schedule is unit-testable in-process via ctypes without
// bootstrapping a mesh. Not part of the session API.

// Fills counts[0..n) and offsets[0..n) with the dim-0-balanced ring
// partition of `count` elements. Returns 0, or -1 on invalid args.
int hvd_ring_partition(long long count, int n, long long* counts,
                       long long* offsets) {
  if (count < 0 || n <= 0 || !counts || !offsets) return -1;
  std::vector<int64_t> c, o;
  RingPartition((int64_t)count, n, &c, &o);
  for (int i = 0; i < n; ++i) {
    counts[i] = (long long)c[(size_t)i];
    offsets[i] = (long long)o[(size_t)i];
  }
  return 0;
}

// Number of pipelined sub-chunk reduce steps for one ring step of
// `step_count` elements of `esize` bytes under HVD_RING_CHUNK_BYTES =
// `chunk_bytes` (after element alignment; 0 = serial = 1). Returns -1
// on invalid args.
long long hvd_ring_subchunk_count(long long step_count, long long esize,
                                  long long chunk_bytes) {
  if (step_count < 0 || esize <= 0) return -1;
  int64_t eff = RingEffectiveChunk((int64_t)chunk_bytes, (int64_t)esize);
  return (long long)RingSubchunkCount(step_count * esize, eff);
}

// --- self-healing-wire test hooks (tests/test_wire.py) ----------------------
// The reconnect protocol's pure math (comm.h/comm.cc), exported so the
// epoch agreement, frame validation, gap computation, and retransmit-
// ring window are unit-testable in-process via ctypes without breaking
// a live mesh (the hvd_ring_partition pattern). Not part of the
// session API; the ring hooks share one static instance and are NOT
// thread-safe (unit-test use only).

long long hvd_wire_retx_gap(long long tx_total, long long peer_rx) {
  return WireRetxGap(tx_total, peer_rx);
}

int hvd_wire_agree_epoch(int proposed, int current) {
  return WireAgreeEpoch(proposed, current);
}

int hvd_wire_frame_check(long long epoch, long long seq,
                         long long cur_epoch, long long expect_seq) {
  return WireFrameCheck(epoch, seq, cur_epoch, expect_seq);
}

static RetxRing g_test_retx;

int hvd_retx_test_reset(long long capacity) {
  if (capacity < 0) return -1;
  g_test_retx.reset((size_t)capacity);
  return 0;
}

int hvd_retx_test_append(const char* data, long long len) {
  if (!data || len < 0) return -1;
  g_test_retx.append(data, (size_t)len);
  return 0;
}

long long hvd_retx_test_begin() { return (long long)g_test_retx.begin(); }
long long hvd_retx_test_end() { return (long long)g_test_retx.end(); }

// Copy stream range [from, from+len) out of the test ring; -1 when the
// range fell out of the bounded window (the abort-on-break fallback
// condition) or was never written.
int hvd_retx_test_read(long long from, long long len, char* out) {
  if (from < 0 || len < 0 || !out) return -1;
  return g_test_retx.read((unsigned long long)from, (size_t)len, out)
             ? 0
             : -1;
}

// --- wire-codec test hooks (tests/test_wire.py) -----------------------------
// Pure functions over codec.cc, exported so the wire formats and the
// quantization round-trip are unit-testable in-process via ctypes
// without bootstrapping a mesh. Not part of the session API.

// Codec id for a name ("none"/"bf16"/"fp16"/"int8" or a decimal id);
// -1 for anything unknown. Mirrors the HVD_WIRE_CODEC parser.
int hvd_codec_from_name(const char* name) {
  return name ? CodecFromName(name) : -1;
}

// On-wire bytes for one block of `count` fp32 elements under `codec`;
// -1 on invalid args.
long long hvd_codec_wire_bytes(int codec, long long count) {
  if (codec < 0 || codec > kCodecMax || count < 0) return -1;
  return (long long)CodecWireBytes(codec, (int64_t)count);
}

// Encode `data[0..count)` then decode it back in place — the exact
// transform payload bytes undergo on the wire. Returns the wire byte
// count, or -1 on invalid args. Python asserts the round-trip error
// against the documented tolerance table (docs/wire.md#compression).
long long hvd_codec_roundtrip(int codec, float* data, long long count) {
  if (codec < 0 || codec > kCodecMax || count < 0 || (!data && count > 0))
    return -1;
  int64_t wb = CodecWireBytes(codec, (int64_t)count);
  std::vector<uint8_t> wire((size_t)wb);
  CodecEncode(codec, data, (int64_t)count, wire.data());
  CodecDecodeRange(codec, wire.data(), (int64_t)count, 0, (int64_t)count,
                   data);
  return (long long)wb;
}

}  // extern "C"
