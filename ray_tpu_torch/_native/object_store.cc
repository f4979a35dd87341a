// Shared-memory object store: the plasma equivalent for this framework.
//
// Design analog: reference `src/ray/object_manager/plasma/` (PlasmaStore,
// ObjectLifecycleManager, EvictionPolicy, PlasmaAllocator over mmap'd shm).
// The reference runs plasma as a server thread inside the raylet with a
// socket-based client protocol; here the store IS the shared memory segment --
// every process on the host attaches the same POSIX shm segment and operates
// on it directly under a process-shared robust mutex.  That removes a socket
// round-trip from every create/get (the reference needs one), at the cost of
// trusting co-located processes, which is the same trust model plasma already
// has (clients mmap the whole segment anyway).
//
// Layout of the segment:
//   [StoreHeader][Entry table (open addressing)][data region]
// The data region is managed by a boundary-tag first-fit allocator with
// neighbor coalescing.  Sealed objects with refcount==0 sit on an LRU list
// and are evicted when an allocation does not fit (plasma's LRU eviction).
//
// Exposed as a C ABI consumed from Python via ctypes (no pybind11 in image).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint64_t kMagic = 0x7261795f74707531ULL;  // "ray_tpu1"
constexpr uint32_t kIdLen = 16;
constexpr uint64_t kAlign = 64;  // cacheline-align objects; also TPU-friendly
constexpr uint64_t kNil = ~0ULL;

// Block header for the boundary-tag allocator. Lives immediately before each
// block's payload in the data region.
struct BlockHeader {
  uint64_t size;       // payload size (aligned)
  uint64_t prev_size;  // payload size of the physically previous block, 0 if first
  uint32_t free_flag;  // 1 if free
  uint32_t last_flag;  // 1 if physically last block
};

struct Entry {
  uint8_t id[kIdLen];
  uint64_t offset;  // payload offset in data region
  uint64_t size;    // user-visible size
  int64_t refcount;
  uint32_t state;  // 0 empty, 1 created(unsealed), 2 sealed, 3 tombstone
  uint32_t pad;
  uint64_t lru_prev;  // Entry index or kNil
  uint64_t lru_next;
  // Crash-reclaim bookkeeping: the creator (while unsealed) and the most
  // recent pinner.  EOWNERDEAD recovery frees unsealed entries whose
  // creator died and unpins entries whose last pinner died — without this,
  // every worker killed mid-operation permanently leaks its memory.
  // (Single-pid tracking is approximate for multi-pinner objects; the
  // rare mis-unpin degrades to an eviction-under-reader, not a crash.)
  int32_t creator_pid;
  int32_t pinner_pid;
};

struct StoreHeader {
  uint64_t magic;
  uint64_t capacity;   // data region bytes
  uint64_t num_slots;  // hash slots
  uint64_t bytes_used;
  uint64_t num_objects;
  uint64_t lru_head;  // eviction candidates, head = oldest
  uint64_t lru_tail;
  uint64_t num_evictions;
  pthread_mutex_t mutex;
};

struct Handle {
  int fd;
  uint8_t* base;  // mapping base
  uint64_t total_size;
  StoreHeader* hdr;
  Entry* table;
  uint8_t* data;  // data region base
  char name[256];
  int owner;  // created (vs attached)
};

inline uint64_t align_up(uint64_t v, uint64_t a) { return (v + a - 1) & ~(a - 1); }

inline BlockHeader* block_at(Handle* h, uint64_t payload_off) {
  return reinterpret_cast<BlockHeader*>(h->data + payload_off - sizeof(BlockHeader));
}

inline uint64_t hash_id(const uint8_t* id) {
  uint64_t v;
  std::memcpy(&v, id, 8);
  uint64_t w;
  std::memcpy(&w, id + 8, 8);
  v ^= w * 0x9e3779b97f4a7c15ULL;
  v ^= v >> 33;
  v *= 0xff51afd7ed558ccdULL;
  v ^= v >> 33;
  return v;
}

void rebuild_from_table(Handle* h);

void lock(Handle* h) {
  int rc = pthread_mutex_lock(&h->hdr->mutex);
  if (rc == EOWNERDEAD) {
    // A process died while holding the lock (workers are SIGTERM'd as part
    // of normal actor teardown, so this is routine, not exceptional).  The
    // allocator block chain and LRU list may be half-updated; walking them
    // as-is can cycle forever WITH THE LOCK HELD, freezing every process
    // on the host.  The entry table is the source of truth -- rebuild the
    // derived structures from it before continuing.
    rebuild_from_table(h);
    pthread_mutex_consistent(&h->hdr->mutex);
  }
}

void unlock(Handle* h) { pthread_mutex_unlock(&h->hdr->mutex); }

// ---- hash table ----

Entry* find_entry(Handle* h, const uint8_t* id) {
  const uint64_t n = h->hdr->num_slots;
  uint64_t slot = hash_id(id) % n;
  for (uint64_t probe = 0; probe < n; ++probe) {
    Entry* e = &h->table[slot];
    if (e->state == 0) return nullptr;
    if (e->state != 3 && std::memcmp(e->id, id, kIdLen) == 0) return e;
    slot = (slot + 1) % n;
  }
  return nullptr;
}

Entry* insert_entry(Handle* h, const uint8_t* id) {
  const uint64_t n = h->hdr->num_slots;
  uint64_t slot = hash_id(id) % n;
  for (uint64_t probe = 0; probe < n; ++probe) {
    Entry* e = &h->table[slot];
    if (e->state == 0 || e->state == 3) {
      std::memcpy(e->id, id, kIdLen);
      e->refcount = 0;
      e->lru_prev = e->lru_next = kNil;
      return e;
    }
    slot = (slot + 1) % n;
  }
  return nullptr;  // table full
}

inline uint64_t entry_index(Handle* h, Entry* e) {
  return static_cast<uint64_t>(e - h->table);
}

// ---- LRU list of evictable (sealed, refcount==0) entries ----

void lru_push_tail(Handle* h, Entry* e) {
  uint64_t idx = entry_index(h, e);
  e->lru_prev = h->hdr->lru_tail;
  e->lru_next = kNil;
  if (h->hdr->lru_tail != kNil) h->table[h->hdr->lru_tail].lru_next = idx;
  h->hdr->lru_tail = idx;
  if (h->hdr->lru_head == kNil) h->hdr->lru_head = idx;
}

void lru_remove(Handle* h, Entry* e) {
  if (e->lru_prev != kNil)
    h->table[e->lru_prev].lru_next = e->lru_next;
  else if (h->hdr->lru_head == entry_index(h, e))
    h->hdr->lru_head = e->lru_next;
  if (e->lru_next != kNil)
    h->table[e->lru_next].lru_prev = e->lru_prev;
  else if (h->hdr->lru_tail == entry_index(h, e))
    h->hdr->lru_tail = e->lru_prev;
  e->lru_prev = e->lru_next = kNil;
}

// ---- allocator ----

void init_allocator(Handle* h) {
  BlockHeader* first = reinterpret_cast<BlockHeader*>(h->data);
  first->size = h->hdr->capacity - sizeof(BlockHeader);
  first->prev_size = 0;
  first->free_flag = 1;
  first->last_flag = 1;
}

inline BlockHeader* next_block(Handle* h, BlockHeader* b) {
  if (b->last_flag) return nullptr;
  return reinterpret_cast<BlockHeader*>(reinterpret_cast<uint8_t*>(b) +
                                        sizeof(BlockHeader) + b->size);
}

inline BlockHeader* prev_block(Handle* h, BlockHeader* b) {
  if (b->prev_size == 0) return nullptr;
  return reinterpret_cast<BlockHeader*>(reinterpret_cast<uint8_t*>(b) -
                                        b->prev_size - sizeof(BlockHeader));
}

// Rebuild the allocator block chain and LRU list from the entry table
// (called on robust-mutex EOWNERDEAD recovery: the table is the source of
// truth; the derived structures may be half-updated by the dead process).
// Entries whose extents are implausible are tombstoned -- losing an object
// is survivable (owners reconstruct from lineage / re-pull), a corrupted
// allocator freezes the whole host.
bool pid_dead(int32_t pid) {
  return pid > 0 && kill(pid, 0) != 0 && errno == ESRCH;
}

void rebuild_from_table(Handle* h) {
  const uint64_t cap = h->hdr->capacity;
  std::vector<Entry*> live;
  for (uint64_t i = 0; i < h->hdr->num_slots; ++i) {
    Entry* e = &h->table[i];
    if (e->state != 1 && e->state != 2) continue;
    uint64_t payload = align_up(e->size < 8 ? 8 : e->size, kAlign);
    // Overflow-safe extent check (subtraction form): a scribbled
    // offset/size must not wrap past cap and drive a wild write below.
    if (payload < e->size || e->offset < sizeof(BlockHeader) ||
        payload > cap || e->offset > cap - payload) {
      e->state = 3;  // implausible extent: drop
      continue;
    }
    // Reclaim crash leftovers: unsealed creations of dead processes can
    // never be sealed, and pins of dead processes can never be released.
    if (e->state == 1 && pid_dead(e->creator_pid)) {
      e->state = 3;
      continue;
    }
    if (e->refcount > 0 && pid_dead(e->pinner_pid)) {
      e->refcount = 0;
      e->pinner_pid = 0;
    }
    live.push_back(e);
  }
  std::sort(live.begin(), live.end(),
            [](Entry* a, Entry* b) { return a->offset < b->offset; });

  h->hdr->lru_head = h->hdr->lru_tail = kNil;
  uint64_t pos = 0;  // next unassigned byte in the data region
  uint64_t prev_payload = 0;
  uint64_t bytes_used = 0, num_objects = 0;
  BlockHeader* prev_alloc = nullptr;
  for (Entry* e : live) {
    uint64_t payload = align_up(e->size < 8 ? 8 : e->size, kAlign);
    uint64_t bstart = e->offset - sizeof(BlockHeader);
    if (bstart < pos) {  // overlaps the previous block: drop
      e->state = 3;
      continue;
    }
    uint64_t gap = bstart - pos;
    if (gap >= sizeof(BlockHeader)) {
      BlockHeader* fb = reinterpret_cast<BlockHeader*>(h->data + pos);
      fb->size = gap - sizeof(BlockHeader);
      fb->prev_size = prev_payload;
      fb->free_flag = 1;
      fb->last_flag = 0;
      prev_payload = fb->size;
    } else if (gap > 0) {
      // Sub-header sliver: fold it into the previous block's payload.
      if (prev_alloc != nullptr) {
        prev_alloc->size += gap;
        prev_payload = prev_alloc->size;
      } else {
        e->state = 3;  // sliver at region start: unrecoverable, drop
        continue;
      }
    }
    BlockHeader* b = reinterpret_cast<BlockHeader*>(h->data + bstart);
    b->size = payload;
    b->prev_size = prev_payload;
    b->free_flag = 0;
    b->last_flag = 0;
    prev_payload = payload;
    prev_alloc = b;
    pos = bstart + sizeof(BlockHeader) + payload;
    bytes_used += e->size;
    num_objects += 1;
    e->lru_prev = e->lru_next = kNil;
    if (e->state == 2 && e->refcount == 0) lru_push_tail(h, e);
  }
  // Trailing free block (or the whole region when empty).
  if (pos + sizeof(BlockHeader) <= cap) {
    BlockHeader* fb = reinterpret_cast<BlockHeader*>(h->data + pos);
    fb->size = cap - pos - sizeof(BlockHeader);
    fb->prev_size = prev_payload;
    fb->free_flag = 1;
    fb->last_flag = 1;
  } else if (prev_alloc != nullptr) {
    prev_alloc->size += cap - pos;  // absorb the tail sliver
    prev_alloc->last_flag = 1;
  }
  h->hdr->bytes_used = bytes_used;
  h->hdr->num_objects = num_objects;
}

// Returns payload offset into data region, or kNil if no fit.
uint64_t alloc_block(Handle* h, uint64_t want) {
  want = align_up(want < 8 ? 8 : want, kAlign);
  // Bounded walk: a corrupted chain (sizes cycling) must degrade to an
  // allocation failure, never an infinite loop under the store lock.
  uint64_t steps = 0;
  const uint64_t max_steps = h->hdr->capacity / kAlign + 2;
  BlockHeader* b = reinterpret_cast<BlockHeader*>(h->data);
  while (b) {
    if (++steps > max_steps) {
      rebuild_from_table(h);
      return kNil;
    }
    if (b->free_flag && b->size >= want) {
      // Split if the remainder can hold a header + a minimal payload.
      if (b->size >= want + sizeof(BlockHeader) + kAlign) {
        uint64_t rest = b->size - want - sizeof(BlockHeader);
        b->size = want;
        uint32_t was_last = b->last_flag;
        b->last_flag = 0;
        BlockHeader* nb = next_block(h, b);
        nb->size = rest;
        nb->prev_size = want;
        nb->free_flag = 1;
        nb->last_flag = was_last;
        if (!was_last) {
          BlockHeader* nnb = next_block(h, nb);
          if (nnb) nnb->prev_size = rest;
        }
      }
      b->free_flag = 0;
      return static_cast<uint64_t>(reinterpret_cast<uint8_t*>(b) - h->data) +
             sizeof(BlockHeader);
    }
    b = next_block(h, b);
  }
  return kNil;
}

void free_block(Handle* h, uint64_t payload_off) {
  BlockHeader* b = block_at(h, payload_off);
  b->free_flag = 1;
  // Coalesce with next.
  BlockHeader* nb = next_block(h, b);
  if (nb && nb->free_flag) {
    b->size += sizeof(BlockHeader) + nb->size;
    b->last_flag = nb->last_flag;
    BlockHeader* nnb = next_block(h, b);
    if (nnb) nnb->prev_size = b->size;
  }
  // Coalesce with prev.
  BlockHeader* pb = prev_block(h, b);
  if (pb && pb->free_flag) {
    pb->size += sizeof(BlockHeader) + b->size;
    pb->last_flag = b->last_flag;
    BlockHeader* nnb = next_block(h, pb);
    if (nnb) nnb->prev_size = pb->size;
  }
}

// Evict LRU objects until `want` bytes could plausibly fit; returns number evicted.
int evict_for(Handle* h, uint64_t want) {
  int evicted = 0;
  uint64_t steps = 0;
  while (h->hdr->lru_head != kNil) {
    if (++steps > h->hdr->num_slots + 1 ||      // cycle guard
        h->hdr->lru_head >= h->hdr->num_slots) {  // bogus index guard
      rebuild_from_table(h);
      return evicted;
    }
    uint64_t off = alloc_block(h, want);
    if (off != kNil) {
      // Undo the probe allocation; caller will re-run alloc_block.
      free_block(h, off);
      return evicted;
    }
    Entry* victim = &h->table[h->hdr->lru_head];
    lru_remove(h, victim);
    free_block(h, victim->offset);
    h->hdr->bytes_used -= victim->size;
    h->hdr->num_objects -= 1;
    h->hdr->num_evictions += 1;
    victim->state = 3;  // tombstone
    evicted++;
  }
  return evicted;
}

}  // namespace

extern "C" {

// Error codes
//  0 ok, -1 not found, -2 out of memory, -3 already exists, -4 bad state,
//  -5 system error, -6 table full

void* store_create(const char* name, uint64_t capacity, uint64_t num_slots) {
  shm_unlink(name);  // fresh segment
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t table_bytes = num_slots * sizeof(Entry);
  uint64_t total = align_up(sizeof(StoreHeader), kAlign) + align_up(table_bytes, kAlign) +
                   capacity;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  uint8_t* base = static_cast<uint8_t*>(
      mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
  if (base == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  Handle* h = new Handle();
  h->fd = fd;
  h->base = base;
  h->total_size = total;
  h->hdr = reinterpret_cast<StoreHeader*>(base);
  h->table = reinterpret_cast<Entry*>(base + align_up(sizeof(StoreHeader), kAlign));
  h->data = base + align_up(sizeof(StoreHeader), kAlign) + align_up(table_bytes, kAlign);
  std::strncpy(h->name, name, sizeof(h->name) - 1);
  h->owner = 1;

  std::memset(h->hdr, 0, sizeof(StoreHeader));
  std::memset(h->table, 0, table_bytes);
  h->hdr->capacity = capacity;
  h->hdr->num_slots = num_slots;
  h->hdr->lru_head = h->hdr->lru_tail = kNil;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->hdr->mutex, &attr);
  pthread_mutexattr_destroy(&attr);

  init_allocator(h);
  h->hdr->magic = kMagic;
  return h;
}

void* store_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  uint8_t* base = static_cast<uint8_t*>(
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
  if (base == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  StoreHeader* hdr = reinterpret_cast<StoreHeader*>(base);
  if (hdr->magic != kMagic) {
    munmap(base, st.st_size);
    close(fd);
    return nullptr;
  }
  Handle* h = new Handle();
  h->fd = fd;
  h->base = base;
  h->total_size = st.st_size;
  h->hdr = hdr;
  h->table = reinterpret_cast<Entry*>(base + align_up(sizeof(StoreHeader), kAlign));
  h->data = base + align_up(sizeof(StoreHeader), kAlign) +
            align_up(hdr->num_slots * sizeof(Entry), kAlign);
  std::strncpy(h->name, name, sizeof(h->name) - 1);
  h->owner = 0;
  return h;
}

void store_detach(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  munmap(h->base, h->total_size);
  close(h->fd);
  if (h->owner) shm_unlink(h->name);
  delete h;
}

int store_create_object(void* hv, const uint8_t* id, uint64_t size, uint64_t* offset_out) {
  Handle* h = static_cast<Handle*>(hv);
  lock(h);
  if (find_entry(h, id)) {
    unlock(h);
    return -3;
  }
  uint64_t need = size < 8 ? 8 : size;
  uint64_t off = alloc_block(h, need);
  if (off == kNil) {
    evict_for(h, align_up(need, kAlign));
    off = alloc_block(h, need);
  }
  if (off == kNil) {
    unlock(h);
    return -2;
  }
  Entry* e = insert_entry(h, id);
  if (!e) {
    free_block(h, off);
    unlock(h);
    return -6;
  }
  e->offset = off;
  e->size = size;
  e->state = 1;
  e->refcount = 1;  // creator holds a ref until seal+release
  e->creator_pid = static_cast<int32_t>(getpid());
  e->pinner_pid = e->creator_pid;
  h->hdr->bytes_used += size;
  h->hdr->num_objects += 1;
  *offset_out = off;
  unlock(h);
  return 0;
}

int store_seal(void* hv, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(hv);
  lock(h);
  Entry* e = find_entry(h, id);
  if (!e) {
    unlock(h);
    return -1;
  }
  if (e->state != 1) {
    unlock(h);
    return -4;
  }
  e->state = 2;
  unlock(h);
  return 0;
}

int store_get(void* hv, const uint8_t* id, uint64_t* offset_out, uint64_t* size_out) {
  Handle* h = static_cast<Handle*>(hv);
  lock(h);
  Entry* e = find_entry(h, id);
  if (!e || e->state != 2) {
    unlock(h);
    return -1;
  }
  if (e->refcount == 0) lru_remove(h, e);
  e->refcount += 1;
  e->pinner_pid = static_cast<int32_t>(getpid());
  *offset_out = e->offset;
  *size_out = e->size;
  unlock(h);
  return 0;
}

int store_release(void* hv, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(hv);
  lock(h);
  Entry* e = find_entry(h, id);
  if (!e) {
    unlock(h);
    return -1;
  }
  if (e->refcount > 0) e->refcount -= 1;
  if (e->refcount == 0 && e->state == 2) lru_push_tail(h, e);
  unlock(h);
  return 0;
}

int store_delete_object(void* hv, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(hv);
  lock(h);
  Entry* e = find_entry(h, id);
  if (!e) {
    unlock(h);
    return -1;
  }
  if (e->refcount > 0) {
    unlock(h);
    return -4;  // in use
  }
  if (e->state == 2) lru_remove(h, e);
  free_block(h, e->offset);
  h->hdr->bytes_used -= e->size;
  h->hdr->num_objects -= 1;
  e->state = 3;
  unlock(h);
  return 0;
}

int store_contains(void* hv, const uint8_t* id) {
  Handle* h = static_cast<Handle*>(hv);
  lock(h);
  Entry* e = find_entry(h, id);
  int r = (e && e->state == 2) ? 1 : 0;
  unlock(h);
  return r;
}

void* store_pointer(void* hv, uint64_t offset) {
  Handle* h = static_cast<Handle*>(hv);
  return h->data + offset;
}

// TEST-ONLY: simulate a process dying mid-operation while holding the store
// lock, leaving derived state corrupted.  Exercises the EOWNERDEAD recovery
// path (rebuild_from_table) deterministically; never called in production.
void store_test_die_holding_lock(void* hv) {
  Handle* h = static_cast<Handle*>(hv);
  pthread_mutex_lock(&h->hdr->mutex);
  h->hdr->lru_head = h->hdr->num_slots + 12345;  // bogus index
  h->hdr->lru_tail = 7;
  _exit(0);  // dies with the robust mutex held
}

// Copy the ids of all sealed objects into ``out`` (kIdLen bytes each).
// Returns the count written; a return value equal to ``max_ids`` may mean
// truncation — callers retry with a larger buffer.  Used by the raylet's
// GCS resync to re-advertise local copies after a control-plane partition.
uint64_t store_list_sealed(void* hv, uint8_t* out, uint64_t max_ids) {
  Handle* h = static_cast<Handle*>(hv);
  lock(h);
  uint64_t n = 0;
  for (uint64_t i = 0; i < h->hdr->num_slots && n < max_ids; ++i) {
    Entry* e = &h->table[i];
    if (e->state == 2) {
      std::memcpy(out + n * kIdLen, e->id, kIdLen);
      ++n;
    }
  }
  unlock(h);
  return n;
}

uint64_t store_capacity(void* hv) { return static_cast<Handle*>(hv)->hdr->capacity; }
uint64_t store_bytes_used(void* hv) { return static_cast<Handle*>(hv)->hdr->bytes_used; }
uint64_t store_num_objects(void* hv) { return static_cast<Handle*>(hv)->hdr->num_objects; }
uint64_t store_num_evictions(void* hv) { return static_cast<Handle*>(hv)->hdr->num_evictions; }

}  // extern "C"
